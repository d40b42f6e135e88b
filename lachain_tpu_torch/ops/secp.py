"""secp256k1 recovery engine: the kernel wrappers, psecp's composites and
`GpuEcdsaRecover`.

The port of `lachain_tpu/ops/psecp.py`. Seven wrappers front the CUDA
kernels of `csrc/secp.cu` (`secp_fp_mul`, `secp_dbl`, `secp_add`,
`build_table`, `msm_scan`, `sqrt`, `mont_convert`); the composite above
them (`recover_kernel`) is plain tensor code over those wrappers, and
`GpuEcdsaRecover` (psecp `TpuEcdsaRecover`, :508-634) keeps psecp's host
work around them: validation, r^-1 by Montgomery's trick, the y^2 check
and parity flip, 4096-signature chunks and the batch affine conversion.

Every wrapper dispatches on the device its tensors lie on, and on nothing
else: on `cuda` it launches its kernel (or raises), on `cpu` it runs the
plain version in `ops/secp_ref.py`. Layouts, each the natural one for its
arithmetic:
  * cuda: int32 rows holding 8 x 32-bit Montgomery limbs per coordinate,
    a point is (24, n); `sqrt` alone takes and gives plain words (8, n)
    (`_words`), converting into and out of Montgomery form on the card;
  * cpu:  int64 rows holding psecp's 26 x 10-bit signed plain limbs in
    32-row slots, a point is (96, n), so the CPU tests compare with psecp
    limb for limb. `mont_convert`, the card's own conversion, works on the
    card's word layout on either device.
`fe_encode` / `fe_decode` and `pt_pack` convert ints into either layout
(on the card one `mont_convert` launch each); `fetch` brings a fused
output buffer (flag row last) to the host in one copy and
`pt_unpack_host` reads Jacobian ints from it.

`LAUNCHES` counts the kernel launches of each wrapper (CUDA only), so a run
can show that its path went through the kernels.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..crypto import ecdsa
from . import _build, glv, secp_ref
from .g1 import _check, _cpu_layout, _on_cpu, _run
from .glv import TABLE, W256
from .verify import ESCAPES, _pow2_at_least, resolve_device

NL = 8  # 32-bit Montgomery limbs per coordinate on the card
ROWS = 3 * NL  # rows of a point on the card
P = ecdsa.P
_R2 = (1 << 512) % P  # x * R^2 / R = x R (R = 2^256): into Montgomery form

# libsecp256k1's addition chain for the square root's exponent (p + 1) / 4
# (secp256k1_fe_sqrt in its field_impl.h), the steps the card's `sqrt`
# runs: step (s, k) squares the running value s times, then multiplies it
# by x_k = y2^(2^k - 1), a value the chain made before (k None: no
# product). From x_1 = y2 the steps make x2, x3, x6, x9, x11, x22, x44,
# x88, x176, x220, x223, then three more: 253 squarings, 13 products.
SQRT_CHAIN = ((1, 1), (1, 1), (3, 3), (3, 3), (2, 2), (11, 11), (22, 22),
              (44, 44), (88, 88), (44, 44), (3, 3), (23, 22), (6, 2),
              (2, None))

LAUNCHES = {"secp_fp_mul": 0, "secp_dbl": 0, "secp_add": 0,
            "secp_table": 0, "secp_msm_scan": 0, "secp_sqrt": 0,
            "secp_mont": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# the seven kernel wrappers
# ---------------------------------------------------------------------------


def secp_fp_mul(x, y):
    """(R, n) x (R, n) -> (R, n) field product x*y mod p (psecp `_mul`)."""
    if _on_cpu(x, y):
        return secp_ref.fp_mul(x, y)
    n = x.shape[-1]
    _check("secp_fp_mul x", x, (NL, n))
    _check("secp_fp_mul y", y, (NL, n))
    out = torch.empty_like(x)
    rc = _run(_build.library().lt_secp_fp_mul, x, x.data_ptr(), y.data_ptr(),
              out.data_ptr(), n)
    _launched("secp_fp_mul", rc)
    return out


def secp_dbl(p):
    """(3R, n) -> (3R, n) Jacobian doubling (replaces psecp `_dbl_kernel`)."""
    if _on_cpu(p):
        return secp_ref.dbl(p)
    n = p.shape[-1]
    _check("secp_dbl p", p, (ROWS, n))
    out = torch.empty_like(p)
    rc = _run(_build.library().lt_secp_dbl, p, p.data_ptr(), out.data_ptr(), n)
    _launched("secp_dbl", rc)
    return out


def secp_add(p, q):
    """(3R, n) x (3R, n) -> (3R, n) incomplete Jacobian add, p != +-q, both
    finite (replaces psecp `_add_kernel`)."""
    if _on_cpu(p, q):
        return secp_ref.add_incomplete(p, q)
    n = p.shape[-1]
    _check("secp_add p", p, (ROWS, n))
    _check("secp_add q", q, (ROWS, n))
    out = torch.empty_like(p)
    rc = _run(_build.library().lt_secp_add, p, p.data_ptr(), q.data_ptr(),
              out.data_ptr(), n)
    _launched("secp_add", rc)
    return out


def build_table(lanes):
    """Points (3R, n) -> (16, 3R, n): entry k = k*P, entry 0 zero and never
    selected, in one launch (replaces psecp `build_table`, :364: its one
    `_dbl_kernel` and 13 chained `_add_kernel` launches, whose values it
    gives word for word)."""
    if _on_cpu(lanes):
        return secp_ref.build_table(lanes)
    n = lanes.shape[-1]
    _check("build_table lanes", lanes, (ROWS, n))
    table = torch.empty((TABLE, ROWS, n), dtype=torch.int32, device=lanes.device)
    rc = _run(_build.library().lt_secp_table, lanes, lanes.data_ptr(),
              table.data_ptr(), n)
    _launched("secp_table", rc)
    return table


def msm_scan(table, digits):
    """table (16, 3R, n), digits (W, n) int32 in [0, 16), MSB-first ->
    ((3R, n) accumulators, (n,) bool infinity flags)
    (replaces psecp `_msm_kernel` / `_msm_scan`)."""
    if _on_cpu(table, digits):
        return secp_ref.msm_scan(table, digits)
    n = table.shape[-1]
    nwin = digits.shape[0]
    if nwin < 1:
        raise ValueError("msm_scan: need at least one window")
    _check("msm_scan table", table, (TABLE, ROWS, n))
    _check("msm_scan digits", digits, (nwin, n))
    lo, hi = torch.aminmax(digits)
    if lo.item() < 0 or hi.item() >= TABLE:  # the kernel indexes table[d]
        raise ValueError("msm_scan: digits must lie in [0, 16)")
    acc = torch.empty((ROWS, n), dtype=torch.int32, device=table.device)
    flags = torch.empty((n,), dtype=torch.bool, device=table.device)
    rc = _run(_build.library().lt_secp_msm_scan, table, table.data_ptr(),
              digits.data_ptr(), acc.data_ptr(), flags.data_ptr(), n, nwin)
    _launched("secp_msm_scan", rc)
    return acc, flags


def sqrt(x):
    """x -> (x^3 + 7)^((p+1)/4), the candidate y of each x (replaces psecp
    `sqrt_kernel`, plain XLA there). Non-residues give values the caller's
    y^2 check rejects. On the card x is (8, n) int32 PLAIN words (`_words`,
    not Montgomery form) and so is y: the kernel converts into and out of
    Montgomery form itself and runs SQRT_CHAIN: 253 squarings and 13
    products a lane, 270 steps with y2's two and the conversions. On the
    CPU x and y are psecp's (26, n) limbs through `secp_ref.sqrt`, psecp's
    square-and-multiply step for step."""
    if _on_cpu(x):
        return secp_ref.sqrt(x)
    n = x.shape[-1]
    _check("sqrt x", x, (NL, n))
    out = torch.empty_like(x)
    rc = _run(_build.library().lt_secp_sqrt, x, x.data_ptr(), out.data_ptr(), n)
    _launched("secp_sqrt", rc)
    return out


def mont_convert(t, into: bool):
    """(8c, n) or (8c + 1, n) int32 words -> the same shape: every
    coordinate (rows 8c' .. 8c' + 7, lane-minor, as the card's buffers lie)
    into Montgomery form, x R mod p (`into`), or out of it, x / R mod p; a
    trailing flag row is copied as it is. One launch reads the buffer as it
    lies: no permute, no copy, no uploaded constant (this port's own
    representation; psecp has no Montgomery form). A CPU tensor in the same
    layout takes the plain version."""
    if t.dim() != 2 or t.shape[0] < NL or t.shape[0] % NL > 1:
        raise ValueError(f"mont_convert: expected (8c [+ 1], n) rows, got {tuple(t.shape)}")
    if _on_cpu(t):
        return secp_ref.mont_mul_words(t, _R2 if into else 1)
    rows, n = t.shape
    _check("mont_convert t", t, (rows, n))
    out = torch.empty_like(t)
    rc = _run(_build.library().lt_secp_mont, t, t.data_ptr(), out.data_ptr(),
              rows, n, int(into))
    _launched("secp_mont", rc)
    return out


# ---------------------------------------------------------------------------
# marshal: ints <-> the device's layout
# ---------------------------------------------------------------------------


def _words(vals: Sequence[int]) -> np.ndarray:
    """ints in [0, 2^256) -> (8, n) uint32 little-endian words."""
    buf = b"".join(int(v).to_bytes(4 * NL, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), NL).T.copy()


def _from_words(a) -> list:
    """(8c, n) uint32 words -> the c * n ints, coordinate by coordinate:
    c0's n lanes, then c1's, ..."""
    a = np.asarray(a, dtype="<u4")
    c, n = a.shape[0] // NL, a.shape[-1]
    raw = np.ascontiguousarray(a.reshape(c, NL, n).transpose(0, 2, 1)).tobytes()
    w = 4 * NL
    return [
        int.from_bytes(raw[i * w : (i + 1) * w], "little")
        for i in range(len(raw) // w)
    ]


def _upload_words(words: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32)).to(device)


def _download_words(t) -> list:
    """(8c, n) plain words on the card -> the c * n ints (`_from_words`)."""
    return _from_words(t.cpu().numpy().view(np.uint32))


def fe_encode(vals: Sequence[int], device="cuda") -> torch.Tensor:
    """Field ints in [0, p) -> (R, n) in the device's layout."""
    if _cpu_layout(device):
        return torch.from_numpy(secp_ref.ints_to_limbs(vals))
    return mont_convert(_upload_words(_words(vals), device), into=True)


def fe_decode(t) -> list:
    """(R, n) in the device's layout -> canonical field ints."""
    if _cpu_layout(t.device):
        return secp_ref.limbs_to_ints(t.numpy())
    return _download_words(mont_convert(t.contiguous(), into=False))


def pt_pack(points: Sequence[Optional[Tuple[int, int]]], device="cuda"):
    """Affine (x, y) tuples (None = infinity) -> Jacobian points with Z = 1
    on `device`, infinity as (0, 1, 0) (psecp `pt_pack`): (96, n) limbs on
    the CPU, (24, n) Montgomery words (one conversion launch) on the card."""
    if _cpu_layout(device):
        return torch.from_numpy(secp_ref.points_to_limbs(points))
    xs = [p[0] if p else 0 for p in points]
    ys = [p[1] if p else 1 for p in points]
    zs = [0 if p is None else 1 for p in points]
    words = np.concatenate([_words(xs), _words(ys), _words(zs)], axis=0)
    return mont_convert(_upload_words(words, device), into=True)


def pt_coords(arr) -> list:
    """Points in the device's layout -> the 3n canonical coordinate ints
    X... | Y... | Z... (no infinity mapping)."""
    if _cpu_layout(arr.device):
        return secp_ref.coords(arr.numpy())
    return fe_decode(arr)


def digits_col(scalars: Sequence[int], device="cuda") -> torch.Tensor:
    """256-bit ints -> (64, n) int32 MSB-first 4-bit digits on `device`
    (psecp `digits_col`)."""
    return torch.from_numpy(glv.digits_col(scalars, W256)).to(device)


def fetch(fused):
    """A fused (rows + 1, m) buffer, flag row last -> (numpy (rows, m) point
    rows, numpy (m,) bool flags) in ONE device->host copy. On the card the
    point rows leave Montgomery form on the device first (one `mont_convert`
    launch, which copies the flag row), so they hold plain field words."""
    if _cpu_layout(fused.device):
        a = fused.numpy()
    else:
        a = mont_convert(fused, into=False).cpu().numpy()
    return a[:-1], a[-1] != 0


def pt_unpack_host(rows, flags, cpu_layout: bool) -> list:
    """(3R, m) numpy point rows + (m,) flags from `fetch` -> Jacobian int
    tuples (x, y, z); a flagged lane or Z == 0 is None (psecp `pt_unpack`)."""
    m = rows.shape[-1]
    if cpu_layout:
        cs = secp_ref.coords(rows)
    else:
        cs = _from_words(rows.view(np.uint32))
    out = []
    for i in range(m):
        x, y, z = cs[i], cs[m + i], cs[2 * m + i]
        out.append(None if flags[i] or z == 0 else (x, y, z))
    return out


# ---------------------------------------------------------------------------
# composites (psecp.py:420-438)
# ---------------------------------------------------------------------------


def chunk_lanes(jobs, m_pad: int):
    """[(R_i, u1_i, u2_i)] -> recover_kernel's lanes and scalars:
    interleaved [R_0, G, R_1, G, ...] affine points and [u1_0, u2_0, u1_1,
    u2_1, ...], padded with (G, 0) pairs to m_pad signatures."""
    g_aff = (ecdsa.GX, ecdsa.GY)
    pts: list = []
    scalars: list = []
    for r_pt, u1, u2 in jobs:
        pts.extend([r_pt, g_aff])
        scalars.extend([u1, u2])
    for _ in range(m_pad - len(jobs)):
        pts.extend([g_aff, g_aff])
        scalars.extend([0, 0])
    return pts, scalars


def recover_layout(rng, signatures: int = 4096):
    """chunk_lanes of seeded signatures, for timing the scan at the
    recovery's layout: distinct R_i (R_0 + i*S, chained affine adds) and
    u1, u2 uniform in [1, N). rng: a random.Random. -> (2n affine points,
    (64, 2n) int32 digits on the CPU)."""
    r = ecdsa._mul(ecdsa.G, rng.randrange(1, ecdsa.N))
    step = ecdsa._mul(ecdsa.G, rng.randrange(1, ecdsa.N))
    jobs = []
    for _ in range(signatures):
        jobs.append((r, rng.randrange(1, ecdsa.N), rng.randrange(1, ecdsa.N)))
        r = ecdsa._add(r, step)
    pts, scalars = chunk_lanes(jobs, signatures)
    return pts, digits_col(scalars, "cpu")


def recover_kernel(lanes, digits):
    """lanes (3R, 2n) interleaved [R_0, G, R_1, G, ...]; digits (W, 2n)
    interleaved [u1_0, u2_0, u1_1, u2_1, ...]. Returns one fused (3R + 1, n)
    buffer: per-signature Q = u1*R + u2*G, the last row its infinity flag
    (psecp `recover_kernel`)."""
    acc, fl = msm_scan(build_table(lanes), digits)
    # sum adjacent lane pairs (u1*R_i, u2*G) -> Q_i
    a, b = acc[:, 0::2].contiguous(), acc[:, 1::2].contiguous()
    fa, fb = fl[0::2], fl[1::2]
    r = secp_add(a, b)
    out = torch.where(fb, a, torch.where(fa, b, r))
    return torch.cat([out, (fa & fb).to(out.dtype)[None, :]], dim=0)


# ---------------------------------------------------------------------------
# batched recovery (psecp `TpuEcdsaRecover`)
# ---------------------------------------------------------------------------


def _batch_inverse(vals: List[int], m: int) -> List[int]:
    """Inverses of every value mod m with ONE modular inversion
    (Montgomery's trick)."""
    k = len(vals)
    pref = [1] * (k + 1)
    for i, v in enumerate(vals):
        pref[i + 1] = pref[i] * v % m
    inv_all = pow(pref[k], -1, m)
    out = [0] * k
    for i in range(k - 1, -1, -1):
        out[i] = pref[i] * inv_all % m
        inv_all = inv_all * vals[i] % m
    return out


class GpuEcdsaRecover:
    """Batched public-key recovery on the card (pool-ingest scale).

    recover_batch(hashes, sigs) -> list of compressed pubkeys / None with
    the semantics of ecdsa.recover_hash. The host does the cheap bigint work
    (validation, u1/u2, r^-1 and the batch affine conversion); the card
    computes every candidate y in one square-root launch and runs the two
    256-bit scalar multiplications of each signature.

    `last_timings` holds the wall seconds of the last call's phases:
    `host_s` (validation, r^-1, the y^2 check and parity, u1/u2), `sqrt_s`
    (marshal, upload, square-root launch, download), `pack_s` (marshal + upload of
    every chunk), `device_s` (every chunk's launches, to a synchronised
    end), `fetch_s` (download + unpack), `affine_s` (batch affine and
    encoding, oracle answers for degenerate Q), `wall_s`."""

    # signatures per launch: 4096 signatures = 8192 lanes (psecp.py:519)
    CHUNK = 4096

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.last_timings: dict = {}

    def recover_batch(self, hashes, sigs) -> list:
        t0 = time.perf_counter()
        if len(hashes) != len(sigs):
            raise ValueError("hashes/sigs length mismatch")
        tm = dict.fromkeys(
            ("host_s", "sqrt_s", "pack_s", "device_s", "fetch_s", "affine_s"), 0.0
        )
        out: list = [None] * len(hashes)
        vals = []  # (index, x, r, s, z, parity)
        for i, (h, sig) in enumerate(zip(hashes, sigs)):
            v = self._validate(h, sig)
            if v is not None:
                vals.append((i, *v))
        t1 = time.perf_counter()
        if vals:
            ys = self._sqrts([v[1] for v in vals])
            t2 = time.perf_counter()
            rinvs = _batch_inverse([v[2] for v in vals], ecdsa.N)
            jobs = []  # (index, R_point, u1, u2)
            for (idx, x, r, s_, z, parity), y, rinv in zip(vals, ys, rinvs):
                if y * y % P != (pow(x, 3, P) + 7) % P:
                    continue  # x^3+7 is a non-residue: invalid signature
                if (y & 1) != parity:
                    y = P - y
                u2 = (ecdsa.N - z) * rinv % ecdsa.N if z else 0
                jobs.append((idx, (x, y), s_ * rinv % ecdsa.N, u2))
            t3 = time.perf_counter()
            tm["host_s"] = (t1 - t0) + (t3 - t2)
            tm["sqrt_s"] = t2 - t1
            for lo in range(0, len(jobs), self.CHUNK):
                self._run_chunk(jobs[lo : lo + self.CHUNK], hashes, sigs, out, tm)
        else:
            tm["host_s"] = t1 - t0
        tm["wall_s"] = time.perf_counter() - t0
        self.last_timings = tm
        return out

    def _sqrts(self, xs: List[int]) -> List[int]:
        """Candidate y of every x: one launch over exactly the batch's
        lanes (psecp.py:532-542 pads them to a power of two, so that XLA
        compiles few shapes; the kernel takes any n). On the card plain
        words go up and come back: `sqrt` converts on the device."""
        if self.device.type == "cpu":
            return fe_decode(sqrt(fe_encode(xs, "cpu")))
        return _download_words(sqrt(_upload_words(_words(xs), self.device)))

    def _run_chunk(self, jobs, hashes, sigs, out, tm) -> None:
        t0 = time.perf_counter()
        m = len(jobs)
        pts, u_digits = chunk_lanes([j[1:] for j in jobs], _pow2_at_least(m))
        lanes = pt_pack(pts, self.device)
        digits = digits_col(u_digits, self.device)
        t1 = time.perf_counter()
        fused = recover_kernel(lanes, digits)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        rows, flags = fetch(fused)  # ONE device->host copy
        qs = pt_unpack_host(rows, flags, self.device.type == "cpu")[:m]
        t3 = time.perf_counter()
        # batch affine: one modular inversion via Montgomery's trick
        zinvs = _batch_inverse([q[2] if q else 1 for q in qs], P)
        for (idx, _r_pt, _u1, _u2), q, zi in zip(jobs, qs, zinvs):
            if q is None:
                # u1*R == +-u2*G degenerates the incomplete pairwise add
                # (Z = 0); adversarially constructible, so the oracle
                # answers for this signature (psecp.py:601-609)
                ESCAPES["ecdsa_recover"] += 1
                out[idx] = ecdsa.recover_hash(hashes[idx], sigs[idx])
                continue
            zi2 = zi * zi % P
            out[idx] = ecdsa._compress((q[0] * zi2 % P, q[1] * zi2 % P * zi % P))
        t4 = time.perf_counter()
        tm["pack_s"] += t1 - t0
        tm["device_s"] += t2 - t1
        tm["fetch_s"] += t3 - t2
        tm["affine_s"] += t4 - t3

    @staticmethod
    def _validate(h: bytes, sig: bytes):
        """Cheap per-signature validation mirroring ecdsa.recover_hash;
        returns (x, r, s, z, parity) or None (psecp.py:617)."""
        if len(sig) != 65 or len(h) != 32:
            return None
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:64], "big")
        v = sig[64]
        if not (1 <= r < ecdsa.N and 1 <= s < ecdsa.N) or v > 3:
            return None
        x = r + (ecdsa.N if v & 2 else 0)
        if x >= P:
            return None
        z = int.from_bytes(h, "big") % ecdsa.N
        return (x, r, s, z, v & 1)
