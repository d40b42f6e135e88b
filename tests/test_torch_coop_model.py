"""A word-level model of csrc/coop.cuh's group field, against Python ints.

The CUDA field code runs only on the card, and a wrong carry bound there
builds without an error and is wrong on rare operands. This file models it
thread by thread, word by word, at T = 1, 2 and 4 threads per lane, for
both of the port's primes (BLS12-381, 12 words; secp256k1, 8 words, whose
p fills its top word), and for secp256k1 at T = 8 (one word a thread): the
carry-save CIOS steps of `fpg_mul` (`cios_step`) with their shuffles, the
settle of the columns into words (`cios_settle`), the ballot carry
resolution of `group_carry` / `settle_add` / `settle_sub` (generate and
propagate bits), the top carry that `F::top_carry` folds into the top
thread's generate bit, and the conditional subtraction of `reduce_once_g`;
`fpg_redc` (the same steps with no word products), `fpg_add` and
`fpg_sub` likewise. It asserts every bound the header
states (u and v below 2^64, each column below 2^33 - 1, the carry word 0
or 1 and zero for BLS12-381, no thread both generating and propagating)
and the canonical result, on edge operands (0, 1, p - 1, words all ones)
and seeded random ones.
"""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu_torch.crypto import ecdsa
from lachain_tpu_torch.crypto import bls12381 as bls

torch.set_num_threads(1)

M32 = (1 << 32) - 1
COLUMN_BOUND = (1 << 33) - 1  # every column stays below it

FIELDS = {
    # (words, p, -p^-1 mod 2^32 as the sources hold it, top_carry)
    "bls12_381": (12, bls.P, 0xFFFCFFFD, False),
    "secp256k1": (8, ecdsa.P, 0xD2253531, True),
}


class Field:
    def __init__(self, name: str, t: int):
        self.words, self.p, self.pinv, self.top_carry = FIELDS[name]
        self.t = t
        self.w = self.words // t
        self.max_column = 0

    def split(self, x: int) -> list:
        """x -> per thread its W words."""
        ws = [(x >> (32 * k)) & M32 for k in range(self.words)]
        return [ws[r * self.w : (r + 1) * self.w] for r in range(self.t)]

    def join(self, threads: list) -> int:
        return sum(v << (32 * (r * self.w + j))
                   for r, ws in enumerate(threads) for j, v in enumerate(ws))

    # -- carries across the group ------------------------------------------

    def group_carry(self, gens: list, props: list):
        """-> (carry into each rank, carry out of the group)."""
        t = self.t
        for g, p in zip(gens, props):
            assert g in (0, 1)
            assert not (g and p), "a thread both generates and propagates"
        G = sum(g << r for r, g in enumerate(gens))
        P = sum(int(p) << r for r, p in enumerate(props))
        S = (G | P) + G
        return [((S ^ P) >> r) & 1 for r in range(t)], (S >> t) & 1

    def _settle(self, threads: list, gens: list, sign: int) -> int:
        """settle_add (sign +1) / settle_sub (sign -1) in place; returns the
        carry (borrow) out of the group."""
        if self.t == 1:
            return gens[0]
        full = 1 << (32 * self.w)
        if sign > 0:
            props = [all(v == M32 for v in ws) for ws in threads]
        else:
            props = [all(v == 0 for v in ws) for ws in threads]
        carries, top = self.group_carry(gens, props)
        for r, ws in enumerate(threads):
            x = sum(v << (32 * j) for j, v in enumerate(ws)) + sign * carries[r]
            threads[r] = [((x % full) >> (32 * j)) & M32 for j in range(self.w)]
            # the chain's own carry out is the one the ballots already
            # counted: the carry out of rank r is G_r | (P_r & c_r)
            assert (x >= full if sign > 0 else x < 0) == bool(props[r] and carries[r])
        return top

    def _local(self, a: list, b: list, sign: int):
        """add_words / sub_words of every thread -> (words, carries)."""
        full = 1 << (32 * self.w)
        out, gens = [], []
        for wa, wb in zip(a, b):
            x = (sum(v << (32 * j) for j, v in enumerate(wa))
                 + sign * sum(v << (32 * j) for j, v in enumerate(wb)))
            out.append([((x % full) >> (32 * j)) & M32 for j in range(self.w)])
            gens.append(int(x >= full) if sign > 0 else int(x < 0))
        return out, gens

    # -- the field ------------------------------------------------------------

    def reduce_once(self, s: list, top: int) -> list:
        if not self.top_carry:
            assert top == 0, "a BLS12-381 sum carried out of the group"
        value = self.join(s) + (top << (32 * self.words))
        assert value < 2 * self.p
        d, gens = self._local(s, self.split(self.p), -1)
        borrow = self._settle(d, gens, -1)
        keep = borrow == 1 and (not self.top_carry or top == 0)
        out = s if keep else d
        assert self.join(out) == value % self.p
        return out

    def add(self, a: list, b: list) -> list:
        s, gens = self._local(a, b, +1)
        top = self._settle(s, gens, +1)
        return self.reduce_once(s, top)

    def sub(self, a: list, b: list) -> list:
        d, gens = self._local(a, b, -1)
        borrow = self._settle(d, gens, -1)
        pm = [[v if borrow else 0 for v in ws] for ws in self.split(self.p)]
        s, gens = self._local(d, pm, +1)
        self._settle(s, gens, +1)  # the carry out is dropped
        return s

    def _step(self, u: list, held: int):
        """cios_step on the step's columns u, which hold the value `held`
        (the columns plus a * b_i in a product, the columns alone in a
        reduction) -> (the new columns, the value they hold)."""
        t, w = self.t, self.w
        pw = self.split(self.p)
        assert all(x < 1 << 64 for ws in u for x in ws)
        assert sum(x << (32 * k) for k, x in enumerate(x for ws in u for x in ws)) == held
        m = ((u[0][0] & M32) * self.pinv) & M32  # rank 0's, broadcast
        c1 = [u[r][w - 1] >> 32 for r in range(t)]
        cin = [0] + c1[:-1]  # shuffle up; rank 0 takes 0
        v = []
        for r in range(t):
            vr = [(u[r][0] & M32) + cin[r] + m * pw[r][0]]
            for j in range(1, w):
                vr.append((u[r][j] & M32) + (u[r][j - 1] >> 32) + m * pw[r][j])
            v.append(vr)
        assert all(x < 1 << 64 for vr in v for x in vr)
        assert v[0][0] & M32 == 0  # m clears column 0
        recv = [v[r + 1][0] & M32 for r in range(t - 1)] + [c1[t - 1]]
        cols = [[0] * w for _ in range(t)]
        for r in range(t):
            for j in range(w - 1):
                cols[r][j] = (v[r][j + 1] & M32) + (v[r][j] >> 32)
            cols[r][w - 1] = recv[r] + (v[r][w - 1] >> 32)
        flat = [x for cs in cols for x in cs]
        assert max(flat) < COLUMN_BOUND
        self.max_column = max(self.max_column, max(flat))
        # the columns hold (held + m * p) / 2^32, below 2p
        assert (held + m * self.p) % (1 << 32) == 0
        value = sum(x << (32 * k) for k, x in enumerate(flat))
        assert value == (held + m * self.p) >> 32 and value < 2 * self.p
        return cols, value

    def mul(self, a: list, b: list) -> list:
        t, w = self.t, self.w
        cols = [[0] * w for _ in range(t)]
        value = 0
        a_int, b_int = self.join(a), self.join(b)
        for i in range(self.words):
            bi = b[i // w][i % w]  # the shuffle from rank i / W
            u = [[cols[r][j] + a[r][j] * bi for j in range(w)] for r in range(t)]
            cols, value = self._step(u, value + a_int * bi)
        out = self._settle_columns(cols, value)
        r_inv = pow(1 << (32 * self.words), -1, self.p)
        assert self.join(out) == a_int * b_int * r_inv % self.p
        return out

    def redc(self, a: list) -> list:
        """fpg_redc: the columns start as a's words, each step adds m * p
        alone."""
        cols = [list(ws) for ws in a]
        value = a_int = self.join(a)
        for _ in range(self.words):
            cols, value = self._step(cols, value)
        out = self._settle_columns(cols, value)
        r_inv = pow(1 << (32 * self.words), -1, self.p)
        assert self.join(out) == a_int * r_inv % self.p
        return out

    def _settle_columns(self, cols: list, value: int) -> list:
        """cios_settle: the columns, which hold `value` < 2p, into words,
        then reduce_once."""
        t, w = self.t, self.w
        # word j = lo(t[j]) + hi(t[j-1]) + carry, one chain a thread; hi
        # of a thread's top column goes to the next thread
        full = 1 << (32 * w)
        cin = [0] + [cols[r][w - 1] >> 32 for r in range(t - 1)]
        words, gens = [], []
        for r in range(t):
            x = (sum((cols[r][j] & M32) << (32 * j) for j in range(w))
                 + sum((cols[r][j - 1] >> 32) << (32 * j) for j in range(1, w))
                 + cin[r])
            words.append([((x % full) >> (32 * j)) & M32 for j in range(w)])
            assert x >> (32 * w) in (0, 1)
            gens.append(x >> (32 * w))
        hi_top = cols[t - 1][w - 1] >> 32
        assert hi_top in (0, 1)
        if self.top_carry:
            assert not (gens[t - 1] and hi_top), "both top carries set"
            gens[t - 1] |= hi_top
        else:
            assert hi_top == 0, "a BLS12-381 column carried out of the group"
        top = self._settle(words, gens, +1)
        assert self.join(words) + (top << (32 * self.words)) == value
        return self.reduce_once(words, top)


def _operands(name: str, seed: int) -> list:
    """Edge operands, then seeded random ones, all in [0, p)."""
    words, p = FIELDS[name][:2]
    edge = {0, 1, 2, p - 1, p - 2, (1 << (32 * words)) % p}
    for k in range(1, words + 1):
        edge.add(((1 << (32 * k)) - 1) % p)  # low k words all ones
        for lo in range(0, words, 2):  # two words all ones at every height
            edge.add((((1 << 64) - 1) << (32 * lo)) % p)
    rng = random.Random(seed)
    return sorted(edge) + [rng.randrange(p) for _ in range(24)]


# (field, T): both primes at 1, 2 and 4 threads a lane, secp256k1 also at
# 8 (one word a thread; BLS12-381's 12 words do not split 8 ways)
CASES = [(name, t) for name in sorted(FIELDS) for t in (1, 2, 4)]
CASES.append(("secp256k1", 8))


@pytest.mark.parametrize("name, t", CASES)
def test_product_model(name, t):
    f = Field(name, t)
    ops = _operands(name, seed=0xC0 + t)
    for x in ops:
        for y in ops[::3]:
            f.mul(f.split(x), f.split(y))
    # the bound is tight: columns use their 33rd bit, and secp256k1's
    # all-ones words reach 2^33 - 2
    assert f.max_column >= 1 << 32
    if name == "secp256k1":
        assert f.max_column == COLUMN_BOUND - 1


@pytest.mark.parametrize("name, t", CASES)
def test_add_sub_model(name, t):
    f = Field(name, t)
    p = f.p
    ops = _operands(name, seed=0xADD + t)
    for x in ops:
        for y in ops:
            s = f.add(f.split(x), f.split(y))
            assert f.join(s) == (x + y) % p
            d = f.sub(f.split(x), f.split(y))
            assert f.join(d) == (x - y) % p


@pytest.mark.parametrize("name, t", CASES)
def test_reduction_model(name, t):
    """fpg_redc, out of Montgomery form: a / R mod p for every a below
    2^(32 words), a >= p included (the card's plain words are any 256-bit
    value)."""
    f = Field(name, t)
    top = (1 << (32 * f.words)) - 1
    for x in _operands(name, seed=0x5ED + t) + [top, top - 1, f.p, f.p + 1]:
        f.redc(f.split(x))


@pytest.mark.parametrize("t", [1, 2, 4])
def test_bls_reduction_full_range(t):
    """fpg_redc for BlsFp over the whole 384-bit range, the G1 conversion
    out of Montgomery form (g1_mont reads whatever the kernels stored): the
    multiples k p, whose columns settle to exactly p before the last
    subtraction, values just below p's multiples and 2^384, and seeded ones
    anywhere below 2^384."""
    f = Field("bls12_381", t)
    top = 1 << (32 * f.words)
    mults = [k * f.p for k in range(1, top // f.p + 1)]
    rng = random.Random(0xF011 + t)
    ops = (mults + [m - 1 for m in mults] + [top - k for k in range(1, 4)]
           + [rng.randrange(top) for _ in range(48)])
    for x in ops:
        f.redc(f.split(x))


@pytest.mark.parametrize("t", [2, 4, 8])
def test_secp_sums_carry_out_of_the_group(t):
    """The case secp256k1 adds to the BLS field: a + b and the product's
    last step reach 2^256, so the carry word must reach the subtraction."""
    f = Field("secp256k1", t)
    p = f.p
    big = p - 1
    s = f.add(f.split(big), f.split(big))
    assert f.join(s) == (2 * big) % p
    seen = []
    orig = f.reduce_once

    def spy(s_, top):
        seen.append(top)
        return orig(s_, top)

    f.reduce_once = spy
    f.add(f.split(big), f.split(big))
    rng = random.Random(5)
    for _ in range(40):
        f.mul(f.split(rng.randrange(p - (1 << 200), p)),
              f.split(rng.randrange(p - (1 << 200), p)))
    assert seen[0] == 1 and 1 in seen[1:]
