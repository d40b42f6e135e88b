"""BLS threshold signatures (signatures in G2, public keys in G1): the
common coin of the port.

The parts of `lachain_tpu/crypto/threshold_sig.py` that the coin era path
needs, with the same algebra, the same hash domain and the same coin bit:
  keys    : x = f(0) for a degree-t polynomial f over Fr; validator i holds
            x_i = f(i+1); shared key Y = g1^x, per-validator Y_i = g1^{x_i}.
  sign    : sigma_i = H_G2(msg)^{x_i}.
  verify  : e(g1, sigma_i) == e(Y_i, H_G2(msg)).
  combine : sigma = Lagrange_0({(i+1, sigma_i)}) in G2; verify against Y.
  parity  : the low bit of keccak256 of the serialized combined signature.
The keys' wire form (`TsPublicKey`, `TsPublicKeySet`, `TsPrivateKeyShare`
`to_bytes` / `from_bytes`, reference :97-135, :303-309) is the JAX
package's bytes; a parse checks each point with `backend`'s deserializer.

The port has no global provider: every operation that does group work
takes its `backend` (a `host.HostBackend`, or a `gpu_backend.GpuBackend`
for the card). `era_verify_combine` runs the whole era through the
backend's `ts_era_verify_combine` where it has one, and only where it has
none through the per-coin host operations; an error on the card's path
propagates. `ThresholdSigner` (reference :331-394) is the per-message
collector the common coin runs on the host: it combines as soon as t+1
shares are in, checks the combined signature with 2 pairings, and only
when that fails isolates the bad shares by the RLC batch check and prunes
them (`pruned`). H_G2(msg) runs through the backend's `hash_to_g2` (the
pure-Python HostBackend where none is given), memoized per (msg,
backend).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from . import bls12381 as bls
from .hashes import keccak256
from .host import HostBackend, batch_bisect_verify, select_distinct
from ..utils.serialization import Reader, write_bytes_list, write_u32
from ..utils import metrics

_SIG_DOMAIN = b"LTPU-TSIG"

_HOST = HostBackend()


@functools.lru_cache(maxsize=4096)
def _hash_cached(msg: bytes, backend) -> tuple:
    return backend.hash_to_g2(msg, _SIG_DOMAIN)


def _hash_to_sig_point(msg: bytes, backend=None) -> tuple:
    """H_G2(msg) through `backend.hash_to_g2`, memoized: every
    sign/verify/combine of one coin hashes the same coin id."""
    return _hash_cached(msg, backend or _HOST)


@dataclass(frozen=True)
class Signature:
    """Combined or partial signature (a G2 point)."""

    sigma: tuple

    def to_bytes(self) -> bytes:
        return bls.g2_to_bytes(self.sigma)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        return cls(bls.g2_from_bytes(data))

    @property
    def parity(self) -> bool:
        """The coin bit: the low bit of keccak256 of the serialized point."""
        return bool(keccak256(self.to_bytes())[0] & 1)


@dataclass(frozen=True)
class PartialSignature:
    sigma: tuple  # G2
    signer_id: int

    def to_bytes(self) -> bytes:
        """The coin message's wire form: the point, then the signer id."""
        return bls.g2_to_bytes(self.sigma) + write_u32(self.signer_id)

    @classmethod
    def from_bytes(cls, data: bytes, backend=None) -> "PartialSignature":
        sigma = (backend or _HOST).g2_deserialize(data[: bls.G2_BYTES])
        r = Reader(data[bls.G2_BYTES :])
        signer = r.u32()
        r.assert_eof()
        return cls(sigma, signer)


class TsPublicKey:
    """Single public key (shared or per-validator), in G1."""

    def __init__(self, y: tuple):
        self.y = y

    def to_bytes(self) -> bytes:
        return bls.g1_to_bytes(self.y)

    @classmethod
    def from_bytes(cls, data: bytes, backend=None) -> "TsPublicKey":
        """Parse with `backend`'s checked G1 deserializer (ValueError on a
        bad point)."""
        return cls((backend or _HOST).g1_deserialize(data))

    @metrics.timed("crypto_ts_verify")
    def verify(self, msg: bytes, sig: Signature, backend) -> bool:
        """e(g1, sigma) == e(Y, H_G2(msg))."""
        h = _hash_to_sig_point(msg, backend)
        return backend.pairing_check(
            [(bls.G1_GEN, sig.sigma), (bls.g1_neg(self.y), h)]
        )


class TsPublicKeySet:
    """All validators' public keys + threshold."""

    def __init__(self, keys: Sequence[TsPublicKey], t: int):
        self.keys = list(keys)
        self.t = t  # t+1 shares assemble a signature
        # shared key = interpolation of the per-validator keys at 0
        xs = list(range(1, len(self.keys) + 1))
        self.shared = TsPublicKey(
            bls.g1_interpolate(xs[: t + 1], [k.y for k in self.keys[: t + 1]])
        )

    @property
    def n(self) -> int:
        return len(self.keys)

    def to_bytes(self) -> bytes:
        return write_u32(self.t) + write_bytes_list([k.to_bytes() for k in self.keys])

    @classmethod
    def from_bytes(cls, data: bytes, backend=None) -> "TsPublicKeySet":
        r = Reader(data)
        t = r.u32()
        keys = [TsPublicKey.from_bytes(b, backend) for b in r.bytes_list()]
        r.assert_eof()
        return cls(keys, t)

    @metrics.timed("crypto_ts_verify_share")
    def verify_share(self, msg: bytes, ps: PartialSignature, backend) -> bool:
        """e(g1, sigma_i) == e(Y_i, H(msg))."""
        if not (0 <= ps.signer_id < len(self.keys)):
            return False
        h = _hash_to_sig_point(msg, backend)
        yk = self.keys[ps.signer_id].y
        return backend.pairing_check(
            [(bls.G1_GEN, ps.sigma), (bls.g1_neg(yk), h)]
        )

    def batch_verify_shares(
        self, msg: bytes, shares: Sequence[PartialSignature], rng, backend
    ) -> List[bool]:
        """Random-linear-combination batch check
          e(g1, sum c_i sigma_i) == e(sum c_i Y_i, H(msg)),
        2 pairings + 1 G2 MSM + 1 G1 MSM for the whole batch; bisect on
        failure to isolate bad shares."""
        if not shares:
            return []
        in_range = [0 <= s.signer_id < len(self.keys) for s in shares]
        live = [i for i, ok in enumerate(in_range) if ok]
        if not live:
            return [False] * len(shares)
        h = _hash_to_sig_point(msg, backend)

        def group_ok(idx: List[int]) -> bool:
            cs = [rng.randbelow((1 << 128) - 1) + 1 for _ in idx]
            sig_agg = backend.g2_msm([shares[live[i]].sigma for i in idx], cs)
            y_agg = backend.g1_msm(
                [self.keys[shares[live[i]].signer_id].y for i in idx], cs
            )
            return backend.pairing_check(
                [(bls.G1_GEN, sig_agg), (bls.g1_neg(y_agg), h)]
            )

        live_results = batch_bisect_verify(group_ok, len(live))
        results = [False] * len(shares)
        for pos, i in enumerate(live):
            results[i] = live_results[pos]
        return results

    @metrics.timed("crypto_ts_combine")
    def combine(self, shares: Sequence[PartialSignature], backend) -> Signature:
        """Lagrange-assemble t+1 partial signatures in G2."""
        chosen = select_distinct(
            shares, key=lambda s: s.signer_id, count=self.t + 1
        )
        if chosen is None:
            raise ValueError(
                f"need {self.t + 1} distinct signer ids, got "
                f"{len(set(s.signer_id for s in shares))}"
            )
        xs = [s.signer_id + 1 for s in chosen]
        cs = bls.fr_lagrange_coeffs(xs, at=0)
        return Signature(backend.g2_msm([s.sigma for s in chosen], cs))


def era_verify_combine(key_set: TsPublicKeySet, coins, rng, backend):
    """Verify + combine many coins' shares at once.

    coins: list of (msg: bytes, shares: Dict[int, PartialSignature]), one
    entry per pending coin, shares keyed by signer id. Returns a list of
    Optional[Signature]: None where a coin has fewer than t+1 in-range
    signers or its chosen shares hold an invalid one.

    Both paths verify exactly the chosen (lowest-signer-id) t+1 shares, the
    ones the combine consumes, so the card and the host agree on every
    input. With a backend that has `ts_era_verify_combine` (GpuBackend) the
    whole era is one pipeline run plus one grand multi-pairing; an error
    there propagates. Otherwise each coin runs batch_verify_shares and
    combine on the backend."""
    out: List[Optional[Signature]] = [None] * len(coins)
    live: List[int] = []
    chosen_per_coin: List[list] = []
    for idx, (_msg, shares) in enumerate(coins):
        valid_ids = sorted(i for i in shares if 0 <= i < key_set.n)
        if len(valid_ids) > key_set.t:
            live.append(idx)
            chosen_per_coin.append(valid_ids[: key_set.t + 1])

    era_fn = getattr(backend, "ts_era_verify_combine", None)
    if era_fn is None or not live:
        for idx, signers in zip(live, chosen_per_coin):
            msg, shares = coins[idx]
            chosen = [shares[i] for i in signers]
            oks = key_set.batch_verify_shares(msg, chosen, rng, backend)
            out[idx] = key_set.combine(chosen, backend) if all(oks) else None
        return out

    # imported here so that host-only users never load torch and the kernels
    from .gpu_backend import CoinJob

    jobs = []
    for idx, signers in zip(live, chosen_per_coin):
        msg, shares = coins[idx]
        cs = bls.fr_lagrange_coeffs([i + 1 for i in signers], at=0)
        lag_row = [0] * key_set.n
        sigma_row: List[Optional[tuple]] = [None] * key_set.n
        for i, c in zip(signers, cs):
            lag_row[i] = c
            sigma_row[i] = shares[i].sigma
        jobs.append(CoinJob(sigma_row, lag_row, _hash_to_sig_point(msg, backend)))
    results = era_fn(jobs, key_set.keys, rng)
    for idx, (ok, comb) in zip(live, results):
        out[idx] = Signature(comb) if ok else None
    return out


class TsPrivateKeyShare:
    """Validator signing share x_i."""

    def __init__(self, x_i: int, my_id: int):
        self.x_i = x_i % bls.R
        self.my_id = my_id

    def to_bytes(self) -> bytes:
        return bls.fr_to_bytes(self.x_i) + write_u32(self.my_id)

    @classmethod
    def from_bytes(cls, data: bytes) -> "TsPrivateKeyShare":
        x = bls.fr_from_bytes(data[: bls.FR_BYTES])
        r = Reader(data[bls.FR_BYTES :])
        my_id = r.u32()
        r.assert_eof()
        return cls(x, my_id)

    @metrics.timed("crypto_ts_sign")
    def sign(self, msg: bytes, backend) -> PartialSignature:
        """sigma_i = H_G2(msg)^{x_i}."""
        h = _hash_to_sig_point(msg, backend)
        return PartialSignature(
            sigma=backend.g2_mul(h, self.x_i), signer_id=self.my_id
        )


class ThresholdSigner:
    """Stateful per-message share collector (reference :331-394).

    Collects shares of `msg`, verifies each on arrival (verify=True) or
    defers the verification to the combine, and produces the combined
    signature once t+1 valid shares are held. Every group op runs on
    `backend`; `rng` draws the RLC weights of the prune's batch check."""

    def __init__(self, msg: bytes, key_share: TsPrivateKeyShare,
                 pub_key_set: TsPublicKeySet, backend, rng):
        self.msg = msg
        self.key_share = key_share
        self.pub_key_set = pub_key_set
        self.backend = backend
        self.rng = rng
        self._shares: Dict[int, PartialSignature] = {}
        self._signature: Optional[Signature] = None
        # signer ids whose shares failed the deferred batch verification:
        # evidence the owning protocol reports
        self.pruned: set = set()

    def sign(self) -> PartialSignature:
        return self.key_share.sign(self.msg, self.backend)

    def _combine_verified(self) -> Optional[Signature]:
        keys = self.pub_key_set
        sig = keys.combine(list(self._shares.values()), self.backend)
        return sig if keys.shared.verify(self.msg, sig, self.backend) else None

    def add_share(self, ps: PartialSignature, verify: bool = True) -> bool:
        """True if the share was accepted. The combined signature is
        available once t+1 distinct valid shares are held."""
        keys = self.pub_key_set
        if self._signature is not None:
            return True  # already done
        if ps.signer_id in self._shares:
            return self._shares[ps.signer_id].sigma == ps.sigma
        if not (0 <= ps.signer_id < keys.n):
            return False
        if verify and not keys.verify_share(self.msg, ps, self.backend):
            return False
        self._shares[ps.signer_id] = ps
        if len(self._shares) >= keys.t + 1:
            self._signature = self._combine_verified()
            if self._signature is None:
                # a bad share slipped in (deferred verification): prune the
                # invalid shares so that they cannot poison a later combine
                held = list(self._shares.values())
                oks = keys.batch_verify_shares(self.msg, held, self.rng, self.backend)
                self.pruned.update(s.signer_id for s, ok in zip(held, oks) if not ok)
                self._shares = {s.signer_id: s for s, ok in zip(held, oks) if ok}
                if len(self._shares) >= keys.t + 1:
                    self._signature = self._combine_verified()
        return True

    @property
    def signature(self) -> Optional[Signature]:
        return self._signature


class TsTrustedKeyGen:
    """Trusted dealer for tests, devnets and the chip smoke run."""

    def __init__(self, n: int, f: int, rng):
        if n <= 3 * f and not (f == 0 and n >= 1):
            raise ValueError("dealer requires n > 3f")
        coeffs = [rng.randbelow(bls.R) for _ in range(f + 1)]
        self._shares = [bls.fr_eval_poly(coeffs, i + 1) for i in range(n)]
        self.pub_key_set = TsPublicKeySet(
            [TsPublicKey(bls.g1_mul(bls.G1_GEN, s)) for s in self._shares],
            t=f,
        )
        # dealer sanity: interpolated shared key matches g1^f(0)
        if not bls.g1_eq(
            self.pub_key_set.shared.y, bls.g1_mul(bls.G1_GEN, coeffs[0])
        ):
            raise AssertionError("dealer: shared key does not interpolate")

    def private_key_share(self, i: int) -> TsPrivateKeyShare:
        return TsPrivateKeyShare(self._shares[i], i)
