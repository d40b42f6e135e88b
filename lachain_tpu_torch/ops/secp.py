"""secp256k1 recovery engine: the kernel wrappers, psecp's composites and
`GpuEcdsaRecover`.

The port of `lachain_tpu/ops/psecp.py`. Five wrappers front the CUDA
kernels of `csrc/secp.cu` (`secp_fp_mul`, `secp_dbl`, `secp_add`,
`msm_scan`, `sqrt`); the composites above them (`build_table`,
`recover_kernel`) are plain tensor code over those wrappers, and
`GpuEcdsaRecover` (psecp `TpuEcdsaRecover`, :508-634) keeps psecp's host
work around them: validation, r^-1 by Montgomery's trick, the y^2 check
and parity flip, 4096-signature chunks and the batch affine conversion.

Every wrapper dispatches on the device its tensors lie on, and on nothing
else: on `cuda` it launches its kernel (or raises), on `cpu` it runs the
plain version in `ops/secp_ref.py`. Layouts, each the natural one for its
arithmetic:
  * cuda: int32 rows holding 8 x 32-bit Montgomery limbs per coordinate,
    a point is (24, n);
  * cpu:  int64 rows holding psecp's 26 x 10-bit signed plain limbs in
    32-row slots, a point is (96, n), so the CPU tests compare with psecp
    limb for limb.
`fe_encode` / `fe_decode` and `pt_pack` convert ints into either layout;
`fetch` brings a fused output buffer (flag row last) to the host in one
copy and `pt_unpack_host` reads Jacobian ints from it.

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
from .g1 import _check, _cpu_layout, _on_cpu, _stream
from .glv import TABLE, W256
from .verify import ESCAPES, _pow2_at_least, resolve_device

NL = 8  # 32-bit Montgomery limbs per coordinate on the card
ROWS = 3 * NL  # rows of a point on the card
P = ecdsa.P
_MONT_R = 1 << 256
_R2 = _MONT_R * _MONT_R % P  # x * R^2 / R = x R: into Montgomery form

LAUNCHES = {"secp_fp_mul": 0, "secp_dbl": 0, "secp_add": 0,
            "secp_msm_scan": 0, "secp_sqrt": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# the five kernel wrappers
# ---------------------------------------------------------------------------


def secp_fp_mul(x, y):
    """(R, n) x (R, n) -> (R, n) field product x*y mod p (psecp `_mul`)."""
    if _on_cpu(x, y):
        return secp_ref.fp_mul(x, y)
    n = x.shape[-1]
    _check("secp_fp_mul x", x, (NL, n))
    _check("secp_fp_mul y", y, (NL, n))
    out = torch.empty_like(x)
    rc = _build.library().lt_secp_fp_mul(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), n, _stream(x)
    )
    _launched("secp_fp_mul", rc)
    return out


def secp_dbl(p):
    """(3R, n) -> (3R, n) Jacobian doubling (replaces psecp `_dbl_kernel`)."""
    if _on_cpu(p):
        return secp_ref.dbl(p)
    n = p.shape[-1]
    _check("secp_dbl p", p, (ROWS, n))
    out = torch.empty_like(p)
    rc = _build.library().lt_secp_dbl(p.data_ptr(), out.data_ptr(), n, _stream(p))
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
    rc = _build.library().lt_secp_add(
        p.data_ptr(), q.data_ptr(), out.data_ptr(), n, _stream(p)
    )
    _launched("secp_add", rc)
    return out


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
    rc = _build.library().lt_secp_msm_scan(
        table.data_ptr(), digits.data_ptr(), acc.data_ptr(), flags.data_ptr(),
        n, nwin, _stream(table),
    )
    _launched("secp_msm_scan", rc)
    return acc, flags


def sqrt(x):
    """(R, n) x -> (R, n) (x^3 + 7)^((p+1)/4), the candidate y of each x
    (replaces psecp `sqrt_kernel`, plain XLA there). Non-residues give
    values the caller's y^2 check rejects."""
    if _on_cpu(x):
        return secp_ref.sqrt(x)
    n = x.shape[-1]
    _check("sqrt x", x, (NL, n))
    out = torch.empty_like(x)
    rc = _build.library().lt_secp_sqrt(x.data_ptr(), out.data_ptr(), n, _stream(x))
    _launched("secp_sqrt", rc)
    return out


# ---------------------------------------------------------------------------
# marshal: ints <-> the device's layout
# ---------------------------------------------------------------------------


def _words(vals: Sequence[int]) -> np.ndarray:
    """ints in [0, 2^256) -> (8, n) uint32 little-endian words."""
    buf = b"".join(int(v).to_bytes(4 * NL, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), NL).T.copy()


def _from_words(a) -> list:
    """(8, n) uint32 words -> ints."""
    raw = np.ascontiguousarray(np.asarray(a, dtype="<u4").T).tobytes()
    w = 4 * NL
    return [
        int.from_bytes(raw[i * w : (i + 1) * w], "little")
        for i in range(len(raw) // w)
    ]


def _mont_apply(t, factor: int):
    """Multiply every coordinate of a (8c, n) CUDA array by the raw word
    constant `factor` in one secp_fp_mul launch: R^2 mod p converts into
    Montgomery form, 1 converts out."""
    c, n = t.shape[0] // NL, t.shape[-1]
    # reshape after permute may return a strided view (n == 1): copy
    flat = t.view(c, NL, n).permute(1, 0, 2).reshape(NL, c * n).contiguous()
    k = torch.from_numpy(_words([factor]).view(np.int32)).to(t.device)
    out = secp_fp_mul(flat, k.expand(NL, c * n).contiguous())
    return out.view(NL, c, n).permute(1, 0, 2).reshape(c * NL, n).contiguous()


def fe_encode(vals: Sequence[int], device="cuda") -> torch.Tensor:
    """Field ints in [0, p) -> (R, n) in the device's layout."""
    if _cpu_layout(device):
        return torch.from_numpy(secp_ref.ints_to_limbs(vals))
    words = torch.from_numpy(_words(vals).view(np.int32)).to(device)
    return _mont_apply(words, _R2)


def fe_decode(t) -> list:
    """(R, n) in the device's layout -> canonical field ints."""
    if _cpu_layout(t.device):
        return secp_ref.limbs_to_ints(t.numpy())
    plain = _mont_apply(t.contiguous(), 1)
    return _from_words(plain.cpu().numpy().view(np.uint32))


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
    return _mont_apply(torch.from_numpy(words.view(np.int32)).to(device), _R2)


def pt_coords(arr) -> list:
    """Points in the device's layout -> the 3n canonical coordinate ints
    X... | Y... | Z... (no infinity mapping)."""
    if _cpu_layout(arr.device):
        return secp_ref.coords(arr.numpy())
    n = arr.shape[-1]
    return fe_decode(arr.reshape(3, NL, n).permute(1, 0, 2).reshape(NL, 3 * n))


def digits_col(scalars: Sequence[int], device="cuda") -> torch.Tensor:
    """256-bit ints -> (64, n) int32 MSB-first 4-bit digits on `device`
    (psecp `digits_col`)."""
    return torch.from_numpy(glv.digits_col(scalars, W256)).to(device)


def fetch(fused):
    """A fused (rows + 1, m) buffer, flag row last -> (numpy (rows, m) point
    rows, numpy (m,) bool flags) in ONE device->host copy. On the card the
    point rows leave Montgomery form on the device first, so they hold plain
    field words."""
    if _cpu_layout(fused.device):
        a = fused.numpy()
    else:
        plain = _mont_apply(fused[:-1].contiguous(), 1)
        a = torch.cat([plain, fused[-1:]], dim=0).cpu().numpy()
    return a[:-1], a[-1] != 0


def pt_unpack_host(rows, flags, cpu_layout: bool) -> list:
    """(3R, m) numpy point rows + (m,) flags from `fetch` -> Jacobian int
    tuples (x, y, z); a flagged lane or Z == 0 is None (psecp `pt_unpack`)."""
    m = rows.shape[-1]
    if cpu_layout:
        cs = secp_ref.coords(rows)
    else:
        by_coord = rows.reshape(3, NL, m).transpose(1, 0, 2).reshape(NL, 3 * m)
        cs = _from_words(np.ascontiguousarray(by_coord).view(np.uint32))
    out = []
    for i in range(m):
        x, y, z = cs[i], cs[m + i], cs[2 * m + i]
        out.append(None if flags[i] or z == 0 else (x, y, z))
    return out


# ---------------------------------------------------------------------------
# composites (psecp.py:364-438)
# ---------------------------------------------------------------------------


def build_table(lanes):
    """(3R, n) -> (16, 3R, n): entry k = k*P (entry 0 zero and never
    selected). 1 doubling + 13 chained adds, one launch each."""
    two = secp_dbl(lanes)
    rows = [torch.zeros_like(lanes), lanes, two]
    cur = two
    for _ in range(TABLE - 3):
        cur = secp_add(cur, lanes)
        rows.append(cur)
    return torch.stack(rows, dim=0)


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
    (upload, square-root launch, download), `pack_s` (marshal + upload of
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
        """Candidate y of every x: one launch over the batch padded to a
        power of two (psecp.py:532-542)."""
        m = len(xs)
        lanes = fe_encode(xs + [1] * (_pow2_at_least(m) - m), self.device)
        return fe_decode(sqrt(lanes))[:m]

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
