"""The main paths' scan layouts and the scan tools' readers, on the CPU.

`g1.tpke_digits`, `g2.coin_digits` and `secp.recover_layout` make the
layouts at which chip_smoke.py and `lachain_tpu_torch/scan_sweep.py` time
the three scans (the TPKE era's joined G1 scan, the coin era's G2 scan, a
4096-signature recovery chunk), through the same functions the composites
lay out their digits and lanes with (ops/g1.py era_digits, ops/g2.py
ts_era_digits, ops/secp.py chunk_lanes); `g2.coin_lanes` the coin era's
signature lanes for the G2 table build. Also: the sweep's variants
of the shipped sources, its reader of `ptxas -v` for templated kernels,
and chip_smoke.py's mapping of profiler keys to kernels (a templated
kernel demangles with `<T>`).
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import chip_smoke
from lachain_tpu_torch import scan_sweep
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import ecdsa
from lachain_tpu_torch.ops import g1, g2, glv, secp

pytestmark = pytest.mark.kernel

LIVE = 22  # t + 1 of the N=64 eras: combined shares a slot or coin

torch.set_num_threads(1)


def _scalars(digits) -> list:
    """(W, n) MSB-first digits -> the n scalars."""
    out = [0] * digits.shape[1]
    for row in digits:
        out = [(v << 4) | int(d) for v, d in zip(out, row)]
    return out


def test_tpke_digits_are_the_joined_era_layout():
    rng = random.Random(3)
    d = g1.tpke_digits(rng, slots=2).numpy()
    n = 2 * 64
    assert d.shape == (32, 4 * n) and d.dtype == np.int32
    rlc = _scalars(d[:, :n])
    assert (d[:16, : 2 * n] == 0).all()  # rlc16 behind 16 zero windows
    assert _scalars(d[:, n : 2 * n]) == rlc and all(0 < v < 1 << 64 for v in rlc)
    lag1, lag2 = _scalars(d[:, 2 * n : 3 * n]), _scalars(d[:, 3 * n :])
    for i in range(n):
        live = i % 64 < LIVE
        assert (lag1[i] + lag2[i] * glv.LAMBDA > 0) == live
    # the era kernel's own padding of the same digits
    rlc16 = torch.from_numpy(np.ascontiguousarray(d[16:, :n]))
    joined = torch.cat([g1.lead_zeros(rlc16, 32)] * 2
                       + [torch.from_numpy(d[:, 2 * n :])], dim=1)
    assert (joined.numpy() == d).all()


def test_coin_digits_mask_the_same_lanes_on_both_halves():
    rng = random.Random(4)
    d = g2.coin_digits(rng, coins=3).numpy()
    n = 3 * 64
    assert d.shape == (64, 2 * n)
    assert (d[:48, :n] == 0).all()  # rlc16 behind 48 zero windows
    rlc, lag = _scalars(d[:, :n]), _scalars(d[:, n:])
    for i in range(n):
        live = i % 64 < LIVE
        assert (rlc[i] > 0) == live and (lag[i] > 0) == live
        assert rlc[i] < 1 << 64


def test_recover_layout_interleaves_r_and_g():
    """One recovery chunk as GpuEcdsaRecover lays it out (chunk_lanes):
    lanes [R_0, G, R_1, G, ...] with distinct R_i, digits [u1_0, u2_0, ...]
    of full-width scalars; chunk_lanes pads with (G, 0) pairs."""
    pts, d = secp.recover_layout(random.Random(6), signatures=5)
    g = (ecdsa.GX, ecdsa.GY)
    assert len(pts) == 10 and pts[1::2] == [g] * 5 and len(set(pts[0::2])) == 5
    assert d.shape == (glv.W256, 10) and d.dtype == torch.int32
    assert all(0 < u < ecdsa.N for u in _scalars(d.numpy()))
    lanes, scalars = secp.chunk_lanes([(pts[0], 3, 4)], 2)
    assert lanes == [pts[0], g, g, g] and scalars == [3, 4, 0, 0]


def test_coin_lanes_mask_the_same_signers():
    lanes = g2.coin_lanes(random.Random(7), coins=2, k=8, live=3)
    assert len(lanes) == 16
    for i, p in enumerate(lanes):
        assert bls.g2_is_inf(p) == (i % 8 >= 3)
    assert len({p for p in lanes if not bls.g2_is_inf(p)}) == 6


def test_random_digits_have_zero_and_short_lanes():
    d = scan_sweep.random_digits(random.Random(5), 130, 32)
    s = _scalars(d)
    assert s[0] == s[61] == s[122] == 0 and s[1] == 5
    assert d.shape == (32, 130)


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__5_g1_cu15msm_scan_kernelILi4EEEvPKjPKiPjPhii' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__5_g1_cu15msm_scan_kernelILi4EEEvPKjPKiPjPhii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__5_g1_cu10dbl_kernelEPKjPji' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__5_g1_cu10dbl_kernelEPKjPji
    288 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 162 registers, used 0 barriers, 288 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__7_secp_cu20secp_msm_scan_kernelILi4EEEvPKjPKiPjPhii' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__7_secp_cu20secp_msm_scan_kernelILi4EEEvPKjPKiPjPhii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__5_g2_cu15g2_table_kernelILi4EEEvPKjPji' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__5_g2_cu15g2_table_kernelILi4EEEvPKjPji
    480 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 104 registers, used 0 barriers, 480 bytes cumulative stack size
"""


_PTXAS_FIXED = """\
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__5_g1_cu22g1_fixed_tables_kernelILi4ELi4EEEvPKjPji' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__5_g1_cu22g1_fixed_tables_kernelILi4ELi4EEEvPKjPji
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 112 registers, used 1 barriers, 36864 bytes smem
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__5_g1_cu20g1_fixed_scan_kernelILi4EEEvPKjPKiPjPhiii' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__5_g1_cu20g1_fixed_scan_kernelILi4EEEvPKjPKiPjPhiii
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size, 4640 bytes smem
"""


def test_sweep_reads_fixed_base_ptxas_report():
    """The two fixed-base kernels by their own names: neither is taken for
    g1_table_kernel or msm_scan_kernel."""
    assert scan_sweep.parse_ptxas(_PTXAS_FIXED) == {
        "g1_fixed_tables_kernel": {"regs": 112, "stack": 0, "spill_stores": 0,
                                   "spill_loads": 0, "callees": {}},
        "g1_fixed_scan_kernel": {"regs": 128, "stack": 8, "spill_stores": 8,
                                 "spill_loads": 8, "callees": {}},
    }


def test_sweep_reads_templated_ptxas_report():
    assert scan_sweep.parse_ptxas(_PTXAS) == {
        "msm_scan_kernel": {"regs": 96, "stack": 0, "spill_stores": 0,
                            "spill_loads": 0, "callees": {}},
        "dbl_kernel": {"regs": 162, "stack": 288, "spill_stores": 0,
                       "spill_loads": 0, "callees": {}},
        "secp_msm_scan_kernel": {"regs": 72, "stack": 0, "spill_stores": 0,
                                 "spill_loads": 0, "callees": {}},
        "g2_table_kernel": {"regs": 104, "stack": 480, "spill_stores": 0,
                            "spill_loads": 0, "callees": {}},
    }


def test_sweep_variants_edit_copies_of_the_shipped_sources(tmp_path):
    """Every variant's edits find their text in the shipped sources, land
    only in the variant's own copy, and each scan is swept at the other
    values of T."""
    shipped = {f: (scan_sweep._build.CSRC / f).read_text()
               for f in ("g1.cu", "g2.cu", "secp.cu", "coop.cuh")}
    srcs = scan_sweep.variant_sources(tmp_path, {"g1": 4, "g2": 4, "secp": 4})
    assert sorted(srcs) == [
        "g1_T1", "g1_T2", "g1_chainserial", "g1_dblcall", "g1_dbltrio",
        "g1_groupmask", "g1_mulinline", "g1_prefetch", "g2_T1", "g2_T2",
        "g2_dbltrio", "g2_fp2inline", "g2_groupmask", "g2_prefetch",
        "secp_T1", "secp_T2", "secp_T8", "secp_groupmask", "secp_prefetch"]
    assert srcs["g2_T1"][2] == ["-DLT_G2_SCAN_T=1"]
    assert srcs["secp_T2"][2] == ["-DLT_SECP_SCAN_T=2"]
    assert srcs["secp_T8"][2] == ["-DLT_SECP_SCAN_T=8"]
    for name, (scans, edits) in scan_sweep.VARIANTS.items():
        for scan in scans:
            src, inc, defs = srcs[f"{scan}_{name}"]
            assert src == inc / f"{scan}.cu" and defs == []
            for fname, pairs in edits.items():
                text = (inc / fname).read_text()
                assert text != shipped[fname]
                assert all(new in text for _, new in pairs)
    assert {f: (scan_sweep._build.CSRC / f).read_text() for f in shipped} == shipped


_PTXAS_TABLES = """\
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__5_g1_cu15g1_table_kernelILi4EEEvPKjPji' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__5_g1_cu15g1_table_kernelILi4EEEvPKjPji
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__5_g1_cu10add_kernelILi4EEEvPKjS2_Pji' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__5_g1_cu10add_kernelILi4EEEvPKjS2_Pji
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 78 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__7_secp_cu17secp_table_kernelILi2EEEvPKjPji' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__7_secp_cu17secp_table_kernelILi2EEEvPKjPji
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__7_secp_cu15secp_add_kernelILi4EEEvPKjS2_Pji' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__7_secp_cu15secp_add_kernelILi4EEEvPKjS2_Pji
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers
"""


def test_sweep_reads_table_and_add_kernels():
    """The table builds and the group-field adds by their own names: a
    name inside another ("add_kernel" in "secp_add_kernel") is not taken
    for it."""
    got = scan_sweep.parse_ptxas(_PTXAS_TABLES)
    assert sorted(got) == ["add_kernel", "g1_table_kernel", "secp_add_kernel",
                           "secp_table_kernel"]
    assert got["secp_table_kernel"] == {"regs": 96, "stack": 8, "spill_stores": 8,
                                        "spill_loads": 4, "callees": {}}
    assert got["add_kernel"]["regs"] == 78 and got["g1_table_kernel"]["regs"] == 80


_PTXAS_SQRT = """\
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__7_secp_cu16secp_sqrt_kernelILi4EEEvPKjPji' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__7_secp_cu16secp_sqrt_kernelILi4EEEvPKjPji
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__7_secp_cu16secp_mont_kernelILi4EEEvPKjPjiibb' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__7_secp_cu16secp_mont_kernelILi4EEEvPKjPjiibb
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
"""


def test_sweep_reads_sqrt_and_mont_kernels():
    """The group-field square root and the conversion kernel by their own
    names, so the sweep reports their registers at every T."""
    got = scan_sweep.parse_ptxas(_PTXAS_SQRT)
    assert sorted(got) == ["secp_mont_kernel", "secp_sqrt_kernel"]
    assert got["secp_sqrt_kernel"]["regs"] == 64 and got["secp_mont_kernel"]["regs"] == 40


@pytest.mark.parametrize("key, kernel", [
    ("(anonymous namespace)::msm_scan_kernel<4>(unsigned int const*, int "
     "const*, unsigned int*, unsigned char*, int, int)", "msm_scan_kernel"),
    ("(anonymous namespace)::g2_msm_scan_kernel<2>(unsigned int const*)",
     "g2_msm_scan_kernel"),
    ("(anonymous namespace)::dbl_kernel(unsigned int const*, unsigned int*, "
     "int)", "dbl_kernel"),
    ("(anonymous namespace)::secp_msm_scan_kernel(unsigned int const*)",
     "secp_msm_scan_kernel"),
    ("(anonymous namespace)::secp_msm_scan_kernel<4>(unsigned int const*)",
     "secp_msm_scan_kernel"),
    ("(anonymous namespace)::g2_table_kernel<4>(unsigned int const*, "
     "unsigned int*, int)", "g2_table_kernel"),
    ("(anonymous namespace)::g2_add_kernel<4>(unsigned int const*)",
     "g2_add_kernel"),
    ("(anonymous namespace)::g1_table_kernel<4>(unsigned int const*, "
     "unsigned int*, int)", "g1_table_kernel"),
    ("(anonymous namespace)::secp_table_kernel<4>(unsigned int const*, "
     "unsigned int*, int)", "secp_table_kernel"),
    ("(anonymous namespace)::add_kernel<4>(unsigned int const*, unsigned "
     "int const*, unsigned int*, int)", "add_kernel"),
    ("(anonymous namespace)::secp_add_kernel<4>(unsigned int const*)",
     "secp_add_kernel"),
    ("(anonymous namespace)::secp_sqrt_kernel<4>(unsigned int const*, "
     "unsigned int*, int)", "secp_sqrt_kernel"),
    ("(anonymous namespace)::secp_mont_kernel<4>(unsigned int const*, "
     "unsigned int*, int, int, bool, bool)", "secp_mont_kernel"),
    ("void at::native::elementwise_kernel<128, 2>(int, int)", "torch"),
    ("Memcpy DtoH (Device -> Pinned)", "torch"),
])
def test_profiler_keys_map_to_kernels(key, kernel):
    assert chip_smoke.kernel_of(key) == kernel
