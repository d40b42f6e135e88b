"""Trustless distributed key generation (on-chain Joint-Feldman-style DKG).

The port of `lachain_tpu/consensus/keygen.py`: `BiVarSymmetricPolynomial`,
`Commitment`, `CommitMessage`, `ValueMessage`, `KeygenState`,
`ThresholdKeyring` and the per-node driver `TrustlessKeygen`, with the
JAX package's message and snapshot bytes.

Protocol (messages ride on-chain as governance transactions, so every node
processes them in the same total order; that order makes `finished`
deterministic across nodes):

  1. Each dealer d samples a random symmetric bivariate polynomial
     F_d(x, y) of degree f and broadcasts COMMIT: g1^{coeffs} plus, for each
     player i, the ECIES-encrypted row F_d(i+1, .).
  2. On COMMIT from d, player i decrypts row_i, checks it against the
     commitment, and broadcasts VALUE: for each player j, the
     ECIES-encrypted F_d(i+1, j+1).
  3. On VALUE from sender s for dealer d, player i decrypts F_d(s+1, i+1)
     and checks it against d's commitment. Dealer d is finished once
     > 2f senders acked; the keygen once > f dealers finished.
  4. x_i = sum over the first f+1 finished dealers of F_d(0, i+1)
     (interpolated from the valid values); the shared TPKE / TS secret is
     P(0) with P(y) = sum_d F_d(0, y). Nodes broadcast CONFIRM with the
     keyring's hash; at N-f matching confirms the keys go live.

Device work. Every commitment check is a G1 MSM on `backend`: on a
`GpuBackend` they run on the card. `Commitment.evaluate_row` makes its f+1
row MSMs as ONE `backend.g1_msm_batch` (the reference makes f+1 `g1_msm`
calls), `Commitment.evaluate` one `g1_msm` over the distinct
coefficients its (f+1)^2 terms reach (143 lanes at f = 21: the reference
runs all 484 terms, whose repeated points would collide in the card's
incomplete adds), and `try_get_keys` its N+1 key MSMs as one
`g1_msm_batch`. The generator's products of `commit` and of the row
check go through the host's threaded `g1_mul_batch` where the backend's
host has one (`NativeBackend`), else one `g1_mul` each.

SECURITY: the reference's packing is unsafe, and the port keeps it.
`_tri_index(i, j) = i(i+1)/2 + j` (ref keygen.py:51-55) is not injective:
(0, 2) and (1, 1), among others, share a coefficient, so a dealer's
polynomial uses only 143 of its 253 drawn coefficients at f = 21. Then
the decrypted rows of f colluding validators determine every coefficient
the polynomial uses, F_d(0, 0) among them, and so f validators, not
f + 1, can recover the keyring's master secret
(tests/test_torch_keygen.py::test_f_colluders_recover_a_dealers_secret).
The port keeps the packing so that its commitments and snapshots stay
byte-equal to the JAX package's; the fix, an injective packing behind a
versioned snapshot, is open in ROADMAP.md (queue C). Do not rely on this
DKG's secrecy against f colluders.

Differences, by the port's rules: the `backend` (a `GpuBackend`,
`NativeBackend` or `HostBackend`) and the `rng` (`randbelow`; `secrets` in
production) are explicit arguments where the reference reads
`get_backend()` and draws from `secrets`; ECIES draws its ephemeral key and
nonce from the node's rng after the polynomial's coefficients, so a seeded
rng gives the JAX package's polynomial (its ciphertexts, drawn there from
`secrets`, differ). Snapshots hold no ciphertext and are byte-equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..crypto import bls12381 as bls
from ..crypto import ecdsa
from ..crypto import threshold_sig as ts
from ..crypto import tpke
from ..crypto.hashes import keccak256_host
from ..utils.serialization import Reader, write_bytes, write_u32, write_u64
from .keys import PrivateConsensusKeys, PublicConsensusKeys


def _tri_index(i: int, j: int) -> int:
    """Index into the packed triangular coefficient array (symmetric poly).
    The reference's packing, kept for its bytes: it is not injective, which
    lets f colluders recover the secret (the module docstring)."""
    if i > j:
        i, j = j, i
    return i * (i + 1) // 2 + j


def _host(backend):
    """The backend's host ops: a GpuBackend's `host`, else the backend."""
    return getattr(backend, "host", backend)


def _gen_products(scalars: Sequence[int], backend) -> list:
    """g1 * s for each s: one threaded host call where the backend's host
    has `g1_mul_batch`, else one `g1_mul` each."""
    batch = getattr(_host(backend), "g1_mul_batch", None)
    if batch is not None:
        return batch([bls.G1_GEN] * len(scalars), list(scalars))
    return [backend.g1_mul(bls.G1_GEN, s) for s in scalars]


class BiVarSymmetricPolynomial:
    """Random symmetric bivariate polynomial over Fr, degree f in each
    variable, its (f+1)(f+2)/2 coefficients packed by `_tri_index`."""

    def __init__(self, degree: int, coeffs: Sequence[int]):
        if len(coeffs) != (degree + 1) * (degree + 2) // 2:
            raise ValueError("wrong number of coefficients")
        self.degree = degree
        self.coeffs = [c % bls.R for c in coeffs]

    @classmethod
    def random(cls, degree: int, rng) -> "BiVarSymmetricPolynomial":
        count = (degree + 1) * (degree + 2) // 2
        return cls(degree, [rng.randbelow(bls.R) for _ in range(count)])

    def commit(self, backend) -> "Commitment":
        return Commitment(_gen_products(self.coeffs, backend))

    def evaluate_row(self, x: int) -> List[int]:
        """Row polynomial F(x, .) as f+1 Fr coefficients."""
        row = [0] * (self.degree + 1)
        for i in range(self.degree + 1):
            x_pow = 1
            for j in range(self.degree + 1):
                row[i] = (row[i] + self.coeffs[_tri_index(i, j)] * x_pow) % bls.R
                x_pow = x_pow * x % bls.R
        return row


class Commitment:
    """G1 commitment to a symmetric bivariate polynomial. It keeps its wire
    bytes: those it was parsed from, or those of its first serialisation
    (a dealer's own), so that the snapshot persisted after every DKG step
    does not re-serialise its points (a Jacobian point's `g1_to_bytes`
    inverts Z). The coefficients are not changed after construction."""

    def __init__(self, coeffs: Sequence[tuple], wire: Optional[bytes] = None):
        self.coeffs = list(coeffs)
        self._wire = wire
        degree = 0
        while (degree + 1) * (degree + 2) // 2 < len(self.coeffs):
            degree += 1
        if (degree + 1) * (degree + 2) // 2 != len(self.coeffs):
            raise ValueError("invalid commitment coefficient count")
        self.degree = degree

    def evaluate_row(self, x: int, backend) -> List[tuple]:
        """Committed row [sum_j C[i,j] * x^j for i]: the f+1 MSMs in one
        `backend.g1_msm_batch`."""
        d = self.degree + 1
        powers = [pow(x, j, bls.R) for j in range(d)]
        return backend.g1_msm_batch(
            [[self.coeffs[_tri_index(i, j)] for j in range(d)] for i in range(d)],
            [powers] * d,
        )

    def evaluate(self, x: int, y: int, backend) -> tuple:
        """Committed point g1^{F(x,y)} = sum_ij C[tri(i,j)] x^i y^j as one
        `g1_msm` over the distinct coefficients: the (f+1)^2 terms are
        summed by coefficient first. `_tri_index` maps (i, j) and (j, i),
        and also pairs such as (0, 2) and (1, 1), to one coefficient (it
        reaches 143 of the 253 at f = 21), so the terms repeat points, and
        at x == y with equal scalars: two equal partial sums would meet in
        the card's incomplete adds."""
        d = self.degree + 1
        xs = [pow(x, i, bls.R) for i in range(d)]
        ys = [pow(y, j, bls.R) for j in range(d)]
        by_coeff: Dict[int, int] = {}
        for i in range(d):
            for j in range(d):
                t = _tri_index(i, j)
                by_coeff[t] = (by_coeff.get(t, 0) + xs[i] * ys[j]) % bls.R
        return backend.g1_msm([self.coeffs[t] for t in by_coeff], list(by_coeff.values()))

    def to_bytes(self) -> bytes:
        if self._wire is None:
            self._wire = b"".join(bls.g1_to_bytes(c) for c in self.coeffs)
        return self._wire

    @classmethod
    def from_bytes(cls, data: bytes, backend) -> "Commitment":
        """Parse with the backend's checked G1 deserializer (ValueError on
        a bad point)."""
        if len(data) % bls.G1_BYTES != 0:
            raise ValueError("commitment length not a multiple of G1 size")
        parse = _host(backend).g1_deserialize
        return cls([parse(data[o:o + bls.G1_BYTES])
                    for o in range(0, len(data), bls.G1_BYTES)], bytes(data))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Commitment)
            and len(self.coeffs) == len(other.coeffs)
            and all(bls.g1_eq(a, b) for a, b in zip(self.coeffs, other.coeffs))
        )


@dataclass
class CommitMessage:
    """Dealer broadcast: commitment + per-player encrypted rows."""

    commitment: Commitment
    encrypted_rows: List[bytes]

    def to_bytes(self) -> bytes:
        out = write_bytes(self.commitment.to_bytes())
        out += write_u32(len(self.encrypted_rows))
        for row in self.encrypted_rows:
            out += write_bytes(row)
        return out

    @classmethod
    def from_bytes(cls, data: bytes, backend) -> "CommitMessage":
        r = Reader(data)
        commitment = Commitment.from_bytes(r.bytes_(), backend)
        rows = [r.bytes_() for _ in range(r.u32())]
        r.assert_eof()
        return cls(commitment, rows)


@dataclass
class ValueMessage:
    """Player's response to a dealer's commit: encrypted row evaluations."""

    proposer: int
    encrypted_values: List[bytes]

    def to_bytes(self) -> bytes:
        out = write_u32(self.proposer)
        out += write_u32(len(self.encrypted_values))
        for v in self.encrypted_values:
            out += write_bytes(v)
        return out

    @classmethod
    def from_bytes(cls, data: bytes) -> "ValueMessage":
        r = Reader(data)
        proposer = r.u32()
        values = [r.bytes_() for _ in range(r.u32())]
        r.assert_eof()
        return cls(proposer, values)


class KeygenState:
    """Per-dealer progress."""

    def __init__(self, n: int):
        self.commitment: Optional[Commitment] = None
        self.values: List[int] = [0] * n
        # acks follow the shared on-chain message order (deterministic across
        # nodes); valid[] is this node's local check that the decrypted value
        # matched the commitment: only valid values enter interpolation
        self.acks: List[bool] = [False] * n
        self.valid: List[bool] = [False] * n

    def value_count(self) -> int:
        return sum(self.acks)

    def interpolate_values(self) -> int:
        """F_d(0, my_idx+1): the first degree+1 VALID sender values
        interpolated at 0. Any degree+1 commitment-checked points of the
        degree-f row polynomial give the same share, so node-local validity
        cannot skew it; with > 2f acks at least f+1 are from honest
        senders and decrypt validly."""
        if self.commitment is None:
            raise ValueError("cannot interpolate without commitment")
        need = self.commitment.degree + 1
        xs = [i + 1 for i, v in enumerate(self.valid) if v][:need]
        ys = [self.values[x - 1] for x in xs]
        if len(xs) != need:
            raise ValueError("not enough values to interpolate")
        return bls.fr_interpolate(xs, ys, at=0)

    def to_bytes(self) -> bytes:
        commitment = self.commitment.to_bytes() if self.commitment else b""
        return b"".join([
            write_bytes(commitment),
            write_u32(len(self.acks)),
            *(bls.fr_to_bytes(v) for v in self.values),
            bytes(1 if a else 0 for a in self.acks),
            bytes(1 if v else 0 for v in self.valid),
        ])

    @classmethod
    def from_bytes(cls, data: bytes, backend) -> "KeygenState":
        r = Reader(data)
        commitment_bytes = r.bytes_()
        n = r.u32()
        state = cls(n)
        if commitment_bytes:
            state.commitment = Commitment.from_bytes(commitment_bytes, backend)
        state.values = [bls.fr_from_bytes(r.raw(bls.FR_BYTES)) for _ in range(n)]
        state.acks = [b != 0 for b in r.raw(n)]
        state.valid = [b != 0 for b in r.raw(n)]
        r.assert_eof()
        return state

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, KeygenState)
            and self.commitment == other.commitment
            and self.values == other.values
            and self.acks == other.acks
            and self.valid == other.valid
        )


@dataclass
class ThresholdKeyring:
    """Output of a successful keygen."""

    tpke_priv: tpke.TpkePrivateKey
    tpke_pub: tpke.TpkePublicKey
    tpke_verification_keys: List[tpke.TpkeVerificationKey]
    ts_share: ts.TsPrivateKeyShare
    ts_key_set: ts.TsPublicKeySet

    @property
    def public_key_hash(self) -> bytes:
        """keccak(tpke_pub || ts_key_set): the confirmation vote payload."""
        return keccak256_host(self.tpke_pub.to_bytes() + self.ts_key_set.to_bytes())

    def public_keys(self, f: int, ecdsa_pub_keys: List[bytes]) -> PublicConsensusKeys:
        return PublicConsensusKeys(
            n=self.ts_key_set.n,
            f=f,
            tpke_pub=self.tpke_pub,
            tpke_verification_keys=self.tpke_verification_keys,
            ts_keys=self.ts_key_set,
            ecdsa_pub_keys=ecdsa_pub_keys,
        )

    def private_keys(self, ecdsa_priv: Optional[bytes] = None) -> PrivateConsensusKeys:
        return PrivateConsensusKeys(
            tpke_priv=self.tpke_priv, ts_share=self.ts_share, ecdsa_priv=ecdsa_priv
        )


class TrustlessKeygen:
    """DKG driver for one node. Messages are produced and consumed by the
    caller (the chain's governance transactions route them); this class is
    pure protocol state. Its group work runs on `backend`, its draws
    (the polynomial, then ECIES) on `rng`.

    SECURITY: with the reference's `_tri_index` packing, f colluding
    validators recover every dealer's polynomial and so the keyring's
    master secret (the module docstring; ROADMAP.md queue C)."""

    def __init__(self, ecdsa_priv: bytes, ecdsa_pub_keys: Sequence[bytes], f: int,
                 cycle: int, rng, backend):
        self._priv = ecdsa_priv
        self.ecdsa_pub_keys = list(ecdsa_pub_keys)
        self.n = len(self.ecdsa_pub_keys)
        self.f = f
        self.cycle = cycle
        self._rng = rng
        self.backend = backend
        my_pub = ecdsa.public_key_bytes(ecdsa_priv)
        self.my_idx = (
            self.ecdsa_pub_keys.index(my_pub) if my_pub in self.ecdsa_pub_keys else -1
        )
        self.states = [KeygenState(self.n) for _ in range(self.n)]
        self.finished_dealers: List[int] = []
        self.confirmations: Dict[bytes, int] = {}
        self.confirm_sent = False

    # ----- protocol steps -------------------------------------------------

    def start_keygen(self) -> CommitMessage:
        """Dealer step: sample F(x,y), commit, encrypt rows."""
        poly = BiVarSymmetricPolynomial.random(self.f, self._rng)
        commitment = poly.commit(self.backend)
        rows = []
        for i in range(self.n):
            serialized = b"".join(bls.fr_to_bytes(c) for c in poly.evaluate_row(i + 1))
            rows.append(ecdsa.ecies_encrypt(self.ecdsa_pub_keys[i], serialized, self._rng))
        return CommitMessage(commitment, rows)

    def sender_by_public_key(self, pub: bytes) -> int:
        try:
            return self.ecdsa_pub_keys.index(pub)
        except ValueError:
            return -1

    def handle_commit(self, sender: int, msg: CommitMessage) -> ValueMessage:
        """Check my row against the commitment; respond with per-player row
        evaluations. Raises ValueError on any mismatch (the caller treats
        the dealer as faulty)."""
        if not 0 <= sender < self.n:
            raise ValueError(f"commit from unknown sender {sender}")
        if self.my_idx < 0:
            raise ValueError("this node is not a keygen participant")
        if len(msg.encrypted_rows) != self.n:
            raise ValueError("bad encrypted row count")
        if msg.commitment.degree != self.f:
            raise ValueError("commitment degree != f")
        if self.states[sender].commitment is not None:
            raise ValueError(f"double commit from sender {sender}")
        self.states[sender].commitment = msg.commitment
        committed_row = msg.commitment.evaluate_row(self.my_idx + 1, self.backend)
        try:
            raw = ecdsa.ecies_decrypt(self._priv, msg.encrypted_rows[self.my_idx])
        except Exception as e:
            raise ValueError(f"undecryptable row: {e}") from e
        if len(raw) != (self.f + 1) * bls.FR_BYTES:
            raise ValueError("bad row length")
        row = [
            bls.fr_from_bytes(raw[o:o + bls.FR_BYTES])
            for o in range(0, len(raw), bls.FR_BYTES)
        ]
        for got, committed in zip(_gen_products(row, self.backend), committed_row):
            if not bls.g1_eq(got, committed):
                raise ValueError("commitment does not match row")
        return ValueMessage(
            proposer=sender,
            encrypted_values=[
                ecdsa.ecies_encrypt(
                    self.ecdsa_pub_keys[i],
                    bls.fr_to_bytes(bls.fr_eval_poly(row, i + 1)),
                    self._rng,
                )
                for i in range(self.n)
            ],
        )

    def handle_send_value(self, sender: int, msg: ValueMessage) -> bool:
        """Check F_d(sender+1, me+1) against d's commitment; returns True
        exactly once, when this node first sees the keygen finished and
        should broadcast its confirmation."""
        if not 0 <= msg.proposer < self.n:
            raise ValueError(f"value for unknown dealer {msg.proposer}")
        if not 0 <= sender < self.n:
            raise ValueError(f"value from unknown sender {sender}")
        if self.my_idx < 0:
            raise ValueError("this node is not a keygen participant")
        state = self.states[msg.proposer]
        if state.acks[sender]:
            raise ValueError("already handled this value")
        if state.commitment is None:
            raise ValueError("value before commitment")
        if len(msg.encrypted_values) != self.n:
            raise ValueError("bad encrypted value count")
        # the ack is recorded on receipt, after the structural checks every
        # node evaluates identically on the shared on-chain order, so the
        # > 2f quorum (and finished_dealers) is deterministic across nodes.
        # Whether MY ciphertext decrypted to a commitment-consistent value
        # is node-local and only gates interpolation (valid[]): a byzantine
        # sender can neither poison the Lagrange sum nor split the quorum.
        state.acks[sender] = True
        try:
            value = bls.fr_from_bytes(
                ecdsa.ecies_decrypt(self._priv, msg.encrypted_values[self.my_idx])
            )
        except Exception:
            value = None  # structurally fine but undecryptable for me: ack w/o valid
        # the group work runs outside the try: a failed build or launch
        # raises instead of passing for a byzantine sender
        if value is not None:
            expected = state.commitment.evaluate(self.my_idx + 1, sender + 1, self.backend)
            if bls.g1_eq(self.backend.g1_mul(bls.G1_GEN, value), expected):
                state.valid[sender] = True
                state.values[sender] = value
        if state.value_count() > 2 * self.f and msg.proposer not in self.finished_dealers:
            self.finished_dealers.append(msg.proposer)
        if self.confirm_sent:
            return False
        if not self.finished():
            return False
        self.confirm_sent = True
        return True

    def handle_confirm(self, keyring_hash: bytes) -> bool:
        """Count confirmation votes per keyring hash; True exactly when the
        N-f'th matching vote arrives."""
        self.confirmations[keyring_hash] = self.confirmations.get(keyring_hash, 0) + 1
        return self.confirmations[keyring_hash] == self.n - self.f

    def finished(self) -> bool:
        """> f dealers have > 2f acks."""
        return sum(1 for s in self.states if s.value_count() > 2 * self.f) > self.f

    def try_get_keys(self) -> Optional[ThresholdKeyring]:
        """Derive the keyring from the first f+1 finished dealers; the N+1
        key points g1^{P(i)}, i = 0..N, in one `g1_msm_batch`."""
        if not self.finished():
            return None
        # pub-key polynomial = sum of dealers' committed rows at x=0
        pub_key_poly: List[Optional[tuple]] = [None] * (self.f + 1)
        secret = 0
        for dealer in self.finished_dealers[: self.f + 1]:
            state = self.states[dealer]
            if state.value_count() <= 2 * self.f:
                raise RuntimeError("finished dealer without quorum")
            row_zero = state.commitment.evaluate_row(0, self.backend)
            for i, pt in enumerate(row_zero):
                pub_key_poly[i] = (
                    pt if pub_key_poly[i] is None else bls.g1_add(pub_key_poly[i], pt)
                )
            secret = (secret + state.interpolate_values()) % bls.R
        pub_keys = self.backend.g1_msm_batch(
            [pub_key_poly] * (self.n + 1),
            [[pow(i, j, bls.R) for j in range(self.f + 1)] for i in range(self.n + 1)],
        )
        return ThresholdKeyring(
            tpke_priv=tpke.TpkePrivateKey(secret, self.my_idx),
            tpke_pub=tpke.TpkePublicKey(pub_keys[0], t=self.f),
            tpke_verification_keys=[tpke.TpkeVerificationKey(y) for y in pub_keys[1:]],
            ts_share=ts.TsPrivateKeyShare(secret, self.my_idx),
            ts_key_set=ts.TsPublicKeySet([ts.TsPublicKey(y) for y in pub_keys[1:]],
                                         t=self.f),
        )

    # ----- crash-resume serialization ------------------------------------

    def to_bytes(self) -> bytes:
        """Full-state snapshot, persisted after every step (joined once:
        ~1.7 MB at N=64)."""
        out = [write_u32(self.n), write_u32(self.f), write_u64(self.cycle)]
        out += [write_bytes(pub) for pub in self.ecdsa_pub_keys]
        out += [write_bytes(state.to_bytes()) for state in self.states]
        out.append(write_u32(len(self.finished_dealers)))
        out += [write_u32(d) for d in self.finished_dealers]
        out.append(write_u32(len(self.confirmations)))
        out += [write_bytes(h) + write_u32(count) for h, count in self.confirmations.items()]
        out.append(bytes([1 if self.confirm_sent else 0]))
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes, ecdsa_priv: bytes, rng, backend) -> "TrustlessKeygen":
        r = Reader(data)
        n = r.u32()
        f = r.u32()
        cycle = r.u64()
        pub_keys = [r.bytes_() for _ in range(n)]
        keygen = cls(ecdsa_priv, pub_keys, f, cycle, rng, backend)
        keygen.states = [KeygenState.from_bytes(r.bytes_(), backend) for _ in range(n)]
        keygen.finished_dealers = [r.u32() for _ in range(r.u32())]
        keygen.confirmations = {r.bytes_(): r.u32() for _ in range(r.u32())}
        keygen.confirm_sent = r.raw(1)[0] != 0
        r.assert_eof()
        return keygen

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, TrustlessKeygen)
            and self.ecdsa_pub_keys == other.ecdsa_pub_keys
            and self.my_idx == other.my_idx
            and self.states == other.states
            and self.finished_dealers == other.finished_dealers
            and self.confirmations == other.confirmations
            and self.confirm_sent == other.confirm_sent
        )
