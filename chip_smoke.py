#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (lachain_tpu_torch) on one card.

    python3 chip_smoke.py [--seed S]

Phases, each of which must pass (any failure exits non-zero):
  1. build   the CUDA kernels of lachain_tpu_torch/csrc/ (g1.cu, g2.cu,
             secp.cu and rs.cu, one nvcc each, in parallel, sm_90a), with each
             kernel's registers, local bytes, threads per lane and block,
             and the host pairing library of lachain_tpu_torch/crypto/native/
             (g++, GpuBackend's host backend);
  2. kernels hold each of the twenty-one kernels against its plain PyTorch
             version (ops/g1_ref.py, ops/g2_ref.py, ops/secp_ref.py,
             ops/rs_ref.py) on the
             card, on seeded inputs at the main paths' shapes (8192 lanes;
             fp_mul and the doublings also at 8191 (`odd`), fp_mul's
             operands with 0, 1, p-1 and R mod p among them,
             the adds with a p == q lane; the G2 and secp scans with 64
             windows; the three table builds at their main path's lanes:
             the TPKE era's 16,384 joined lanes [u | y | u | phi(u)], the
             coin era's 4096 signature lanes, 22 live of each 64 and the
             others infinity, and one 4096-signature recovery chunk's 8192
             lanes [R_i, G], each table's entries 1, 2, 3 and 15 also held
             against the host's scalar multiples; the secp square root on
             plain words at 16384 lanes and at the recovery's 9,980; the
             secp Montgomery conversions out of and into form on a (25,
             8192) buffer with a flag row, the G1 ones (g1_mont) out of
             form, into it and by beta on a (37, 8192) buffer with a flag
             row and into form on the coin era's (72, 4096) G2 pack; the
             GLV era's fixed-base kernels at N=64 and at N=256:
             g1_fixed_tables over the N keys (a block a key: the doubling
             chain once, the 16 tables in log depth), entries (0, 1), (7,
             15), (15, 1), (15, 15) also against the host's multiples, and
             g1_fixed_scan over the N x N key lanes (4096, 65,536; a lane's
             windows over 4 sub-lanes) with 64-bit RLC digits, a
             zero-digit and an all-zero lane, the N=256 numbers under
             `n256`): exact
             equality of coordinates mod p and flags (of the conversions,
             words bit for bit, and Python ints); the Reed-Solomon product
             (rs_matmul8, rs_matmul16) bit for bit at every launch shape of
             the RBC flushes: GF(2^8) (64 x 22)(22 x 8,384), the N=64
             re-encode, (64 x 22)(22 x 131), the own proposal's encode,
             one grouped decode launch of 64 distinct (22 x 22) inverses
             over 131 columns each, and (64 x
             22)(22 x 82,624), a 10,000-transaction block's; GF(2^16) (256
             x 86)(86 x 1,280), the N=256 re-encode, (256 x 86)(86 x 5),
             the encode, and the decode of 256 distinct (86 x 86)
             inverses over 5 columns each; and ragged widths with zero
             rows and columns in both fields.
             The three scans run twice: at the main path's layout (the TPKE
             era's joined scan, 32 windows x 16,384 lanes; the coin era's
             scan, 48 leading zero windows on its RLC half and 22 live
             lanes of 64; one 4096-signature recovery chunk, [R_i, G]
             interleaved), over the tables built there, and at a
             random-digit kernel check (32 / 64 windows of random digits x
             8192 lanes). Every kernel's numbers in the kernels JSON are
             those of its kernel check, the shape the earlier slices
             reported; each scan's entry and the square root's also hold a
             `main` object, their numbers at the main path's layout;
  3. warmup  the node-start warmup (crypto/warmup.warmup_era_kernels(64,
             backend)) is started and joined: the fully masked TPKE era
             at each slot tier, largest first, and one coin era, on a
             GpuBackend of its own; it must end with no error;
  4. main    twenty-five paths (twenty-seven where more than one card is
             visible),
             each with the kernel launch counts set to 0 just before its
             counted calls and read just after; the paths before the mesh
             paths run on one card however many are visible:
             the N=64 TPKE era (64 ACS slots x 64 decryption shares) through
             GpuBackend(pipeline=GpuEraPipeline()).tpke_era_verify_combine
             on one card: every slot
             must verify and decrypt, with exactly 1 G1 table build, 1 G1
             scan, 6 tree adds, 4 G1 conversions (g1_mont), no doubling and
             no fp_mul; a poisoned share must isolate exactly its slot, 4
             slots are held against the port's HostEraPipeline, and the
             host backend's pairing (the native library) must equal the
             pure-Python HostBackend's on the era's grand-check pairs and
             on the same pairs with one slot poisoned;
             the same era's TPKE flush through
             consensus/crypto_batcher.TpkeEraBatcher (run_flush_path): a
             node's 64 one-job submissions in one chunk, a 64-validator
             in-process fleet's 4096 jobs with one slot poisoned deduped to
             64, and the node's submissions in 4 chunks of 16; every
             callback result must equal the synchronous era call's, with
             TPKE_LAUNCHES a chunk (the keys packed once) counted and,
             at depth 2, traced; then 6 flushes of the one-chunk and
             4-chunk configurations at depth 1 and 2 in turns, with each
             chunk's phases and the card's idle share;
             the same N=64 era through GpuBackend(pipeline=GlvEraPipeline())
             (run_glv_path): a fresh backend's first era launches the key
             tables once (GLV_FIRST), a warm era exactly 1 G1 table build
             over [u | u | phi(u)] (12,288 lanes), 1 G1 scan, 1 fixed-base
             scan over the 4096 key lanes, 6 tree adds, 3 g1_mont, no
             doubling, no fp_mul (GLV_LAUNCHES, traced as counted); every
             slot decrypts, a poisoned share isolates its slot, 4 slots equal
             HostEraPipeline's; then GpuTpkeVerifier on slot 0 (K=64) and
             curve.g1_msm / g2_msm at n=100 with 256 bits against the host,
             and msm.tpke_era_glv_kernel's (S, 4) output against era_kernel's;
             the N=64 coin era (64 coins x 64 signers, 22 live shares each)
             through threshold_sig.era_verify_combine on the same backend:
             every signature must verify under the shared key with the host
             combine's parity, with exactly 1 G2 table build, 1 G2 scan, 12
             G2 adds and no G2 doubling (and the key RLC's 1 G1 table
             build, 1 G1 scan and 6 adds; 3 g1_mont), a poisoned share must isolate exactly
             its coin, 4 coins are held against TsHostEraPipeline, and one
             device g1_msm and one g2_msm at n=100 against the host MSM;
             pool-ingest ECDSA recovery of 10,000 signatures from 64 senders
             (32 of them malformed) through
             ecdsa.recover_hash_batch(..., device="cuda"): every valid
             signature must recover its sender's key, every malformed one
             and 64 valid ones must equal ecdsa.recover_hash, the launches
             must be exactly one square root over the 9,980 x values that
             pass validation and, per 4096-signature chunk, 1 table build, 1
             scan, 1 pair add and 2 Montgomery conversions (no doubling, no
             secp_fp_mul); a crafted
             u1*R == u2*G
             signature, in a call of its own, must be answered by the host
             oracle exactly once;
             the RBC flush of one validator's era (its own proposal's encode,
             one interpolation per slot, each slot losing a seeded 0..n-k
             shards, an equivocating slot and a slot of mixed shard sizes)
             through RbcEraBatcher(device="cuda") at N=64 (GF(2^8)) and at
             N=256 (GF(2^16)), proposals the size of a 1,000-transaction
             block's share: every verdict must equal scalar_verdict on the
             host (None on the two bad slots), the encode rs.encode's (or
             GF.matmul's past n = 255), and a cold flush (no cached inverse)
             must launch exactly 3 rs_matmul (encode, the decode of every
             erasure pattern, re-encode);
             the N=64 TPKE era on a virtual mesh of the card
             (parallel/mesh.py, run_mesh_path): GpuBackend(pipeline=
             MeshEraPipeline(devices=[cuda:0] * n)) at n = 1 (1x1), 2 (2x1)
             and 8 (4x2), every shard's kernels launched on the one card:
             a fresh backend's first era launches exactly mesh_launches
             (per shard a table build, a scan, its tree and 2 g1_mont; the
             cross-shard adds; a key pack per share block; one fetch), and
             every slot's (ok, combined) equals the tpke_era path's on the
             same rng; on the 4x2 mesh also sharded_g1_msm / sharded_g2_msm
             at n=100 over 4 shards against GpuBackend.g1_msm / g2_msm;
             the RBC flushes above through RbcEraBatcher(mesh=make_mesh(
             [cuda:0] * 2)) (rbc_flush_mesh): every group's columns in 2
             blocks, exactly 6 rs_matmul launches a flush, verdicts and
             encode equal to the one-card flush's and scalar_verdict's.
             Where more than one card is visible, the same era over every
             card (mesh_era_cards, the sharded MSMs over them too) and the
             RBC flushes over every card (rbc_flush_cards), with the same
             checks; a machine with one card runs neither;
             the root era (consensus.root_protocol.RootProtocol at every
             validator through the routers' extra_factories, over
             consensus/simulator.SimulatedNetwork on the card, both
             batchers): root_era_64, N=64, f=21, TAKE_FIRST, every
             validator proposing its 16 seeded transfers (177 bytes each,
             signed with the native sign_hash by 64 seeded senders; a
             1,000-transaction block's share) into HoneyBadger, signing the
             header natively and making the block at N-f signatures, the
             producer (RootProducer) recovering the block's senders on the
             card (core/types.warm_sender_caches), run to every router's
             block under torch.profiler: one block at every router, at
             least N-f slots each its proposer's batch, the block's
             transfers exactly theirs in the reference's order, each
             sender its signer's address, at least N-f multisig entries
             each verifying natively; the G1 era kernels, rs_matmul8 and
             the recovery's secp kernels (sqrt, table, scan, add, mont)
             launched; its wall, messages, each batcher's flushes and
             summed phases, the coins' host seconds, the header round's
             sign / verify seconds, the block recovery's phases and the
             card's busy share (traced device time / wall); and
             root_era_16_check, N=16, f=5, TAKE_RANDOM, 8 transfers a
             validator, router 0's decryption shares corrupted, once on the
             card and once with device="cpu" (the era on the host
             pipeline, the RBC flush and the block's sender recovery on
             the plain versions, the senders recovered afresh in each;
             the plain era kernels are held in phase 2 at full width):
             equal blocks, messages,
             flush counts and evidence (every honest router convicts
             exactly router 0, invalid_share, "dec");
             the same two eras through the native consensus engine
             (consensus/native_rt.NativeSimulatedNetwork over the port's
             g++ build of consensus/native/consensus_rt.cpp, both
             batchers): root_era_native_64, root_era_64's keys, proposals,
             parent and seed with RootProtocol hosted natively at every
             validator (set_root_context), traced whole: root_era_64's
             checks, its block hash and delivered_count, no per-message
             crossing (opaque_message, acs_result, coin_request 0;
             hb_acs and root_produce N), traced launches equal to the
             counted ones; printed its wall, messages a second, the
             engine's natively handled messages, the crossings, the
             batchers' phases, the coins' seconds, the header round, the
             recovery and the busy share; root_era_64 and
             root_era_native_64 each run inside an "era" span
             (utils/tracing.py, the rings sized TRACE_CAPACITY) and print
             their era report (tracing.era_report_table: the phases, the
             named waits, the unattributed idle) and their critical path's
             longest segments (the whole path in chiprun_out/), checked:
             no event dropped, phases + waits + unattributed equal to the
             wall within 10%, tpke_decrypt and rbc_device time, the
             native era's cross:* events equal to its `crossings` op for
             op, consensus_messages_processed >= delivered_count on the
             Python engine and 0 on the native one (check_era_report);
             root_era_native_64_untraced, the native era again with the
             engine's recorder at capacity 0: root_era_64's block hash and
             delivered_count; and root_era_native_16_check,
             root_era_16_check's era with router 0's HoneyBadger (and so
             its RootProtocol) kept in Python and malicious through
             `_extra_factories`, card against device="cpu" (as
             root_era_16_check's), with the same checks;
             the same eras under faults and malicious validators
             (network/faults.py, consensus/adversary.py):
             root_era_adversary_native_64, root_era_native_64's era with
             f = 21 equivocating validators (1, 4, ..., 61; installed
             before the first request, their coin, HoneyBadger and Root in
             Python), traced whole: one block at every honest router
             (root_era_64's checks), every honest router convicting
             exactly the 21 of equivocation ("dec" for each, only "dec"
             and "coin" slots, no invalid_share), hb_acs and root_produce
             43, opaque crossings > 0, traced launches equal to the
             counted ones; root_era_adversary_16, the same attack at
             N=16, f=5 (cut from the Python engine's N=64 era to pay
             for rotation_64):
             the native engine's era with the same checks, then the same
             era and plan on the Python engine, held to the native era's
             block hash and record sets; chaos_era_16_check, the N=16 era (TAKE_FIRST) under
             FaultPlan(seed=7, drop 0.10, duplicate 0.05, delay 0.05,
             reorder 0.05, router 3 down over CHAOS_CRASH, {0,1,2,3} |
             {12,...,15} over CHAOS_PARTITION) on the Python engine, on
             the card and with device="cpu" (the era on the host
             pipeline): every router's block, every fault fired, outbox
             replay rounds > 0, both legs equal (blocks, messages, fault
             tally, recovery rounds, flushes, no evidence); and
             chaos_era_native_16_check, the native engine under what it
             can express (duplicate 0.05, reorder 0.5 -> TAKE_RANDOM,
             router 15 crashed for good -> muted) with validators 1 and 2
             spamming 2,600 junk coin slots each: every live router's
             block, no evidence, both legs equal, and a plan with drops
             refused by name;
             crash recovery (consensus/journal.ConsensusJournal, one a
             validator, storage/kv.py): root_era_journal_native_64,
             root_era_native_64's era journaled on MemoryKV and traced
             whole (run A: root_era_64's block and messages, every
             router's journal holding "coin", "dec" and "hdr" records and
             no slot twice), then, once on a SqliteKV file a validator and
             once on an LsmKV directory a validator (storage/lsm.py),
             journaled and stopped at CRASH_AT messages (run B: the network
             and every store closed, the crash; each crashed LsmKV store
             passes fsck with no fatal issue), then restarted from the
             reopened stores on a fresh network of the same seed, every router
             re-armed from its journal (rearm_sent) before its first
             request, traced whole: run A's block at all 64 routers, sends
             replayed from the journals (replayed_sends > 0, no more than
             run B journaled), every store's rows equal to run A's journal
             (each slot once, the sequences continued), every LsmKV store
             clean under fsck, at router 0 every
             journaled coin and decryption share re-derived with zeroed
             bytes handed back as recorded; walls, messages, records a
             router, journal bytes, each engine's write_batch seconds and
             a validator's share of run A's wall,
             replayed sends, flushes, traced device time and busy shares;
             and root_era_journal_16, the crash and restart on the Python
             engine at N=16, f=5 (16 transfers a validator), every
             protocol's sends journaled on MemoryKV through the routers'
             factory: an uncrashed run A, then a crash at half of its
             messages and the restart: run A's block and messages, each
             slot journaled once, replayed sends, journals covering every
             latchable kind;
             the DKG (consensus/keygen.py, dkg_16): one validator's whole
             keygen at N=16, f=5 on one_card_backend (cut from N=64; the
             N=64 keygen runs whole inside rotation_64), its row
             checks one g1_msm_batch each, its value checks one g1_msm
             each over the distinct coefficients, its keyring one batch
             of 17 groups; the other 15 dealers the harness's (a real
             ECIES row and real values for validator 0, seeded fillers
             for the others), two byzantine senders, the state
             snapshotted and resumed after dealer 7's round: every dealer
             finished, the confirm at dealer 5's 11th sender and at the
             11th vote, the keyring equal to the polynomials', TS and TPKE
             round trips, exactly the counted G1 launches (dkg_launches),
             one value round traced by kernel;
             the storage (storage/trie.py, state.py, lsm.py, fsck.py,
             shrink.py; state_commit_1m): one validator's state on LsmKV,
             a genesis of 1,000,000 accounts (1,024 seeded senders, the
             rest keccak256(i)[:20], seeded 32-byte balances), then two
             blocks of 10,000 natively signed transfers whose senders
             core/types.warm_sender_caches recovers on the card (exactly
             recover_launches(10,000) a block, each sender the signing
             key's address); each block's transaction and balance rows and
             its block rows (written by the harness, as execution would)
             committed through StateManager.freeze_and_commit
             (streamed, subtrie-sharded), a quick fsck after every commit
             clean; the last block's writes frozen again serially give the
             same roots; the store reopened gives the height, every
             height's roots and 1,000 sampled balances; DbShrink
             (retain_depth 1) sweeps the genesis-only nodes and a deep
             fsck is then clean; walls, commit_stats, merkle_stats, the
             engine's stats, nodes and bytes on disk, the state hash, and
             what the LSM engine's flight recorder, drained after every
             commit, fed lsm_wal_fsync_seconds and
             lsm_wal_group_commit_records over the commits; its
             temporary directory kept for
             execution (core/block_manager.py, tx_pool.py,
             block_producer.py, execution.py, system_contracts.py,
             parallel_exec.py and the WASM VM of vm/; block_exec_1m,
             run_exec_path): on that store at height 2, one validator's
             BlockManager (device the card), pool and BlockProducer
             produce blocks 3-6 as a node does: 10,000 transfers from the
             1,024 senders at 3 and at 4 (16 of them overdrawn: status 0),
             17 deploys (16 counters and a proxy assembled by vm/builder.py),
             64 native_token transfers and 32 validators' becomeStaker +
             submitVrf at 5, 2,048 counter calls (512 through the proxy,
             one out of gas, one bad selector) at 6; each block's
             senders recovered at its ingest on the card (exactly
             recover_launches(n), each its signing key's address), none
             in production, every receipt's status the harness's, each
             header's state hash checked; blocks 4 and 6 emulated again
             serially and with 8 lanes over their parents' roots (the
             committed state hash and receipts); the store reopened: height
             6, the roots, blocks, blooms, 100 receipts and transactions,
             a sender's address index, a clean quick fsck, and each
             counter's get() through VirtualMachine equal to its
             successful inc() calls; per block the ingest, proposal,
             create_header and produce_block walls and transactions a
             second, the WASM calls' gas, the lanes' walls; the txtrace
             timelines of the sampled transactions (utils/txtrace.py), each
             pool -> propose -> exec -> commit and its stages summing to its
             end-to-end span, their count and median stage seconds; shrink and the
             deep fsck read the nodes and marks by prefix scans,
             and the path prints its peak RSS;
             validator rotation (core/validator_status.py,
             keygen_manager.py, validator_manager.py, vault.py,
             consensus/attendance.py; rotation_64, run_rotation_path): one
             cycle (set_cycle_params(20, 10, 5)) of an N=64 chain on a
             fresh LsmKV store, each block's senders recovered at its
             ingest on the card (exactly recover_launches(n)), blocks
             through TransactionPool, BlockProducer and a BlockManager on
             the card, every header co-signed by the era's set but 2
             seeded absentees: 64 stakes, 64 VRF proofs, the lottery's
             close; validator 0's KeyGenManager on the card, persisting
             into the chain's store and rebuilt from it halfway through
             the value round, against the harness's 63 dealers (dkg_16's
             cut: real ECIES only for validator 0's entries, two
             byzantine senders); the confirm quorum at the 43rd vote, the
             keys installed into a wallet file (saved, reloaded),
             FinishCycle at block 19; ValidatorManager's eras 19 and 20;
             era 20's N=64 TPKE and coin eras under the DKG's keys
             (validator 0's shares from the wallet); block 20 co-signed by
             the new set and validator 0's attendance report, which block
             21 checks in: the winners, every keygen check, the confirmed
             set the polynomials', the resumed state the saved one, every
             slot and coin, the attendance counts the signatures';
             exactly dkg_launches(64, 21, 64, 64 * 63) in the manager,
             recover_launches(n) an ingest, TPKE_LAUNCHES and
             COIN_LAUNCHES in the eras.
             Around each counted call and the MSMs, no result may have been
             recomputed on the host (ops/verify.ESCAPES), and each path
             must launch its kernels;
  5. times   per-kernel times from CUDA events, the plain versions' times,
             each kernel's bound, the warm phase times of every path (the
             eras' `pairing_s` with the host backend's name; the RBC flush's
             cold phases with its host inverses apart, its warm phases each
             the best of 2, and its wall with device="cpu" and with the
             numpy GF.matmul oracle) and a torch.profiler split of each
             device phase by kernel, whose traced launches of each path's
             kernels must equal the counted ones; the GLV key tables'
             first call, and 6 warm GLV and Pallas-path eras in turns
             (medians and quartiles of the wall and the device phase, the
             traced device time by kernel, the idle share); 6 warm eras
             of each mesh in turns with the tpke_era path's backend
             (medians and quartiles of launch, device (events) and wall,
             the mesh's gather_mb, a warm era's traced device time by
             kernel and the idle share), and 4 warm RBC flushes a field on
             the 2-shard mesh in turns with the one-card flush.
The last three lines of standard output are the kernels JSON, the card's
name and power limit, and {"ok": true, "device": {...}}.

Without a CUDA device it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import random
import re
import shutil
import subprocess
import sys
import time

from lachain_tpu_torch.consensus.honey_badger import HoneyBadger
from lachain_tpu_torch.storage.kv import SqliteKV
from lachain_tpu_torch.storage.lsm import LsmKV

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and float32
# outside the tensor cores, 67 TFLOP/s = 33.5 T fused multiply-adds/s. The
# kernels' operations are 32-bit integer multiply-adds, counted 2 operations
# each like an FMA; Hopper issues them at no more than the float32 rate, so
# the bound from this peak is a floor.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# one 12 x 32-bit Montgomery product (CIOS): 2*12*12 + 12 word products
OPS_PER_FIELD_MUL = 2 * (2 * 12 * 12 + 12)
MULS_DBL, MULS_ADD = 7, 16  # field products per doubling / incomplete add
MULS_DBL2, MULS_ADD2 = 16, 44  # the same over Fp2 (G2), in Fp products
# of an add's products, those that read only q: q.z^2 and q.z^3
MULS_ZPOW, MULS_ZPOW2 = 2, 5
# the table builds: per lane 1 doubling and 13 adds of the lane's point,
# whose z powers are made once
MULS_TABLE = MULS_DBL + MULS_ZPOW + 13 * (MULS_ADD - MULS_ZPOW)  # G1, secp: 191
MULS_TABLE2 = MULS_DBL2 + MULS_ZPOW2 + 13 * (MULS_ADD2 - MULS_ZPOW2)  # 528
# one 8 x 32-bit secp256k1 Montgomery product: 2*8*8 + 8 word products; a
# secp doubling / add is 7 / 16 of them like G1's
OPS_PER_SECP_MUL = 2 * (2 * 8 * 8 + 8)
# one secp256k1 squaring needs 8*9/2 distinct a_i*a_j and the reduction's
# 8*8 + 8 (the kernels run it as a product, so their time pays 136)
OPS_PER_SECP_SQR = 2 * (8 * 9 // 2 + 8 * 8 + 8)
# word products of one conversion of a coordinate: the reduction out of
# Montgomery form, 8 steps of m and m * p (the product into form, 136, is
# timed beside it)
MONT_WORD_PRODUCTS = 8 * (8 + 1)
# the same over BLS12-381's 12 words (g1_mont)
G1_MONT_WORD_PRODUCTS = 12 * (12 + 1)
# the Reed-Solomon product's bound: one term (a GF(2^16) exp lookup) a
# lane a clock on every SM, 132 SMs x 32 lanes x the H100 SXM's 1.98 GHz
# boost clock (NVIDIA's H100 data sheet and Hopper white paper)
LOOKUPS_PER_S = 132 * 32 * 1.98e9
# the GF(2^8) nibble design's integer operations: 64 INT32 lanes an SM
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# host idle time around each profiled step (profile_device)
TRACE_PAD_S = 0.05

N_VALIDATORS = 64
KERNEL_LANES = 8192  # S*K*2 msm lanes of the N=64 eras
# the doublings' second check: a partial last block and warp, infinity
# lanes among the lanes
ODD_LANES = 8191
COIN_LANES = 4096  # the coin era's signature lanes: 64 coins x 64 signers
LIVE = 22  # t + 1 of the N=64 eras: the combined shares of a coin
SQRT_LANES = 16384  # the square root's kernel check of the earlier slices
# the x values of the 10,000-signature batch that pass validation (the
# 9,976 signatures that reach the scans and the 4 non-residue x): the
# recovery's square root runs exactly these lanes
RECOVER_SQRT_LANES = 9980
N_SIGNATURES = 10000
N_SENDERS = 64
# the RBC eras: N validators, each proposing 1000 // N transfers of a
# 1,000-transaction block (lachain_tpu/core/block_producer.py:29, :118)
RBC_ERAS = (64, 256)
BLOCK_TXS = 1000
# every counted RBC flush: the encode, the decode of every erasure pattern
# and the re-encode, one launch each
RBC_LAUNCHES = 3
KERNEL_NAMES = ("fp_mul_kernel", "dbl_kernel", "add_kernel", "msm_scan_kernel",
                "g1_table_kernel", "g1_mont_kernel", "g1_fixed_tables_kernel",
                "g1_fixed_scan_kernel",
                "g2_dbl_kernel", "g2_add_kernel", "g2_msm_scan_kernel",
                "g2_table_kernel",
                "secp_fp_mul_kernel", "secp_dbl_kernel", "secp_add_kernel",
                "secp_msm_scan_kernel", "secp_sqrt_kernel", "secp_table_kernel",
                "secp_mont_kernel", "rs_matmul8_kernel", "rs_matmul16_kernel")
G1_KERNELS = ("fp_mul", "g1_dbl", "g1_add", "g1_table", "g1_msm_scan", "g1_mont",
              "g1_fixed_tables", "g1_fixed_scan")
# the fixed-base key kernels serve the GLV era path only
GLV_ONLY = ("g1_fixed_tables", "g1_fixed_scan")
# the wrapper's kernel name -> the CUDA kernel's
KERNEL_OF = {"fp_mul": "fp_mul_kernel", "g1_dbl": "dbl_kernel",
             "g1_add": "add_kernel", "g1_msm_scan": "msm_scan_kernel"}
KERNEL_OF.update({k: f"{k}_kernel" for k in ("g1_table", "g1_mont", "g1_fixed_tables",
                                              "g1_fixed_scan", "g2_dbl", "g2_add",
                                              "g2_msm_scan", "g2_table",
                                              "secp_fp_mul", "secp_dbl", "secp_add",
                                              "secp_table", "secp_msm_scan",
                                              "secp_sqrt", "secp_mont",
                                              "rs_matmul8", "rs_matmul16")})
# the TPKE era's counted call: one table build over the joined lanes (one
# launch), one scan, a tree reduce of log2(64) = 6 adds; 4 G1 conversions
# (g1_mont: the share pack into Montgomery form, the key pack of the
# backend's first era, phi's product by beta, the fetch out of form), no
# fp_mul
TPKE_LAUNCHES = {"g1_msm_scan": 1, "g1_table": 1, "g1_dbl": 0, "g1_add": 6,
                 "g1_mont": 4, "fp_mul": 0}
# a warm GLV era (GlvEraPipeline, the key tables cached): one table build
# and one scan over [u | u | phi(u)] (12,288 lanes at N=64), the
# fixed-base scan over the 4096 key lanes, ONE tree of log2(64) = 6 adds;
# 3 g1_mont (the share pack, phi's product by beta, the fetch); no
# doubling, no fp_mul, no table of the keys. A key set's first era adds
# one g1_fixed_tables and one g1_mont (the key pack).
GLV_LAUNCHES = {"g1_table": 1, "g1_msm_scan": 1, "g1_fixed_scan": 1, "g1_add": 6,
                "g1_mont": 3, "g1_dbl": 0, "fp_mul": 0, "g1_fixed_tables": 0}
GLV_FIRST = dict(GLV_LAUNCHES, g1_fixed_tables=1, g1_mont=4)
# the coin era's counted call: one G2 table build (one launch) and one
# G2 scan over [table | table], two G2 tree reduces of 6 adds; the key RLC
# as one G1 table build, scan and tree reduce; 3 g1_mont (the G2 signature
# pack, the key pack of the first coin era, the fetch)
COIN_LAUNCHES = dict(TPKE_LAUNCHES, g2_table=1, g2_msm_scan=1, g2_add=12,
                     g2_dbl=0, g1_mont=3)
G2_KERNELS = ("g2_dbl", "g2_add", "g2_table", "g2_msm_scan")
SECP_KERNELS = ("secp_fp_mul", "secp_dbl", "secp_add", "secp_table",
                "secp_msm_scan", "secp_sqrt", "secp_mont")
RS_KERNELS = ("rs_matmul8", "rs_matmul16")
# the doublings serve no main path since each table build is one launch,
# secp_fp_mul none since the conversions are secp_mont, fp_mul none since
# the G1 conversions and phi's product by beta are g1_mont
NO_PATH = ("g1_dbl", "g2_dbl", "secp_dbl", "secp_fp_mul", "fp_mul")
# the mesh paths: MeshEraPipeline over n copies of cuda:0 (1x1, 2x1, 4x2),
# every sharded code path on the one card; their warm eras in turns with
# the tpke_era path's; the RBC flush's column shards over 2 copies
MESH_SIZES = (1, 2, 8)
MESH_ROUNDS = 6
RBC_MESH = 2


def one_card_backend(dev):
    """GpuBackend on `dev` with a one-card TPKE era pipeline: where more
    cards are visible, GpuBackend() would take a mesh over them, and the
    paths before the mesh paths run on one card."""
    from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
    from lachain_tpu_torch.ops.verify import GpuEraPipeline

    return GpuBackend(device=dev, pipeline=GpuEraPipeline(device=dev))


def mesh_launches(grid, k: int = N_VALIDATORS) -> dict:
    """A fresh mesh pipeline's first era at K = k (a power of two) over the
    (n_slot, n_share) device grid: per shard one share pack and phi's
    product by beta (g1_mont), one table build and one scan over [u | y |
    u | phi(u)], log2(k / n_share) tree adds; per slot row log2(n_share)
    adds over the share shards; one key pack per share block and device
    (a virtual mesh keeps one copy on cuda:0 for every row) and one
    fetch."""
    import numpy as np

    n_slot, n_share = grid.shape
    shards = n_slot * n_share
    key_packs = len({(dev, c) for (_r, c), dev in np.ndenumerate(grid)})
    return {"g1_table": shards, "g1_msm_scan": shards, "g1_dbl": 0, "fp_mul": 0,
            "g1_add": shards * (k // n_share).bit_length() - shards
            + n_slot * (n_share.bit_length() - 1),
            "g1_mont": 2 * shards + key_packs + 1}


class SeededRng:
    """`randbelow` over a seeded random.Random (the rng API the port takes)."""

    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def check(cond, msg: str) -> None:
    """A failed check fails the run (kept under python -O, unlike assert)."""
    if not cond:
        raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over `reps` calls, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_once(fn):
    """(result, device ms) of one call of fn(), with no warm call: for the
    plain versions whose one call takes seconds."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: int, nops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float(max((abs(x - y) for x, y in zip(a, b)), default=0))


def scan_products(digits, mul_dbl: int, mul_add: int) -> int:
    """Field products the digits need: from each lane's leading nonzero
    digit on, 4 doublings per window and one add per later nonzero digit."""
    import torch

    d = digits.cpu()
    nwin, n = d.shape
    nz = d != 0
    lead = torch.where(nz.any(0), nz.int().argmax(0), torch.full((n,), nwin))
    dbls = int((4 * (nwin - 1 - lead).clamp(min=0)).sum())
    adds = int(nz.sum()) - int(nz.any(0).sum())
    return dbls * mul_dbl + adds * mul_add


def report_line(name: str, r: dict) -> None:
    for label, x in (("", r), (" main", r.get("main")), (" n256", r.get("n256")),
                     (" odd", r.get("odd"))):
        if x is None:
            continue
        shape = f"lanes={x['lanes']}" + (f" windows={x['windows']}" if "windows" in x else "")
        log(f"kernel {name}{label}: {x.get('layout', '')} {shape} ok={x['ok']} "
            f"max_abs_err={x['max_abs_err']} ms={x['ms']:.4f} "
            f"plain_ms={x['plain_ms']:.3f} bound_ms={x['bound'][0]:.5f} "
            f"({x['bound'][1]})")


def scan_entry(kernel, plain, coords, ktab, rtab, digits, muls_dbl, muls_add,
               point_bytes, layout: str, reps: int,
               ops_per_mul: int = OPS_PER_FIELD_MUL) -> dict:
    """One scan (`kernel`, its `plain` version, the `coords` reader) on the
    same table and digits: exactness, CUDA-event times of both, and the
    bound of the work these digits need."""
    import torch

    acc, fl = kernel(ktab, digits)
    (racc, rfl), plain_ms = cuda_ms_once(lambda: plain(rtab, digits))
    got, want = coords(acc), coords(racc.cpu())
    flags_ok = bool(torch.equal(fl.cpu(), rfl.cpu()))
    n = ktab.shape[-1]
    muls = scan_products(digits, muls_dbl, muls_add)
    nbytes = ktab.numel() * 4 + digits.numel() * 4 + point_bytes * n + n
    return dict(
        layout=layout, lanes=n, windows=int(digits.shape[0]),
        ok=got == want and flags_ok, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: kernel(ktab, digits), reps), plain_ms=plain_ms,
        bound=bound(nbytes, muls * ops_per_mul), want=want, flags=rfl.cpu(),
    )



def odd_dbl_entry(dbl, plain, coords, pack, ref, points, inf, z_rows,
                  point_bytes: int, muls: int, reps: int,
                  ops_per_mul: int = OPS_PER_FIELD_MUL) -> dict:
    """A doubling (`dbl`, its `plain` version, the `coords` reader) at
    ODD_LANES lanes, every third lane from lane 1 infinity (0, 1, 0), the
    others taken from `points`: word for word, Z = 0 kept on the infinity
    lanes (coordinate rows `z_rows`), CUDA-event times of both and the
    bound of `muls` products a lane at `ops_per_mul` operations each."""
    n = ODD_LANES
    live = iter(points)
    pts = [inf if i % 3 == 1 else next(live) for i in range(n)]
    kp, rp = pack(pts), ref(pts)
    got, want = coords(dbl(kp)), coords(plain(rp).cpu())
    inf_z = all(want[r * n + i] == 0 for r in z_rows for i in range(1, n, 3))
    return dict(
        layout="infinity every third lane", lanes=n, ok=got == want and inf_z,
        max_abs_err=max_err(got, want), ms=cuda_ms(lambda: dbl(kp), reps),
        plain_ms=cuda_ms(lambda: plain(rp), 3),
        bound=bound(2 * point_bytes * n, n * muls * ops_per_mul),
    )


def fp_mul_entry(rng: random.Random, dev, n: int) -> dict:
    """fp_mul (a lane on SCAN_T threads) at n lanes, with 0, 1, p - 1 and R
    mod p among the operands: its Montgomery words word for word against
    x y R mod p, its values against g1_ref.fp_mul's and Python ints,
    CUDA-event times of both and the bound of its bytes (two operands in,
    one out) and one product a lane."""
    import numpy as np
    import torch

    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.ops import g1, g1_ref

    P, r = bls.P, 1 << 384
    edge = [0, 1, P - 1, r % P]
    xs = edge + [rng.randrange(P) for _ in range(n - len(edge))]
    ys = list(reversed(edge)) + [rng.randrange(P) for _ in range(n - len(edge))]
    kx, ky = g1.fp_encode(xs, dev), g1.fp_encode(ys, dev)
    rx = torch.from_numpy(g1_ref.ints_to_limbs(xs)).to(dev)
    ry = torch.from_numpy(g1_ref.ints_to_limbs(ys)).to(dev)
    prod = g1.fp_mul(kx, ky)
    words = g1._from_words(prod.cpu().numpy().view(np.uint32))
    got = g1.fp_decode(prod)
    want = g1_ref.limbs_to_ints(g1_ref.fp_mul(rx, ry).cpu().numpy())
    check(want == [x * y % P for x, y in zip(xs, ys)], "g1_ref.fp_mul wrong")
    words_ok = words == [x * y * r % P for x, y in zip(xs, ys)]
    return dict(
        lanes=n, ok=got == want and words_ok, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g1.fp_mul(kx, ky), 200),
        plain_ms=cuda_ms(lambda: g1_ref.fp_mul(rx, ry), 5),
        bound=bound(3 * 48 * n, n * OPS_PER_FIELD_MUL),
    )


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


def check_kernels(seed: int, dev):
    import torch

    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.ops import g1, g1_ref, glv

    rng = random.Random(seed)
    n = KERNEL_LANES
    report = {}

    def ref_pts(points):
        return torch.from_numpy(g1_ref.points_to_limbs(points)).to(dev)

    # (1) fp_mul, with 0, 1, p-1 and R = 2^384 mod p among the operands,
    # at n lanes and at ODD_LANES
    mul, odd = fp_mul_entry(rng, dev, n), fp_mul_entry(rng, dev, ODD_LANES)
    report["fp_mul"] = dict(mul, ok=mul["ok"] and odd["ok"], odd=odd)

    # (2) g1_dbl and (3) g1_add on n Jacobian points (Z != 1), lane 7 of the
    # add holding p == q (Z = 0 on both sides); the doubling also at
    # ODD_LANES with infinity lanes
    ps = glv.point_run(rng, n)
    qs = glv.point_run(rng, n)
    qs[7] = ps[7]
    kp, kq = g1.g1_pack(ps, dev), g1.g1_pack(qs, dev)
    rp, rq = ref_pts(ps), ref_pts(qs)
    got = g1.g1_coords(g1.g1_dbl(kp))
    want = g1.g1_coords(g1_ref.dbl(rp).cpu())
    for i in range(0, n, 997):
        pt = (want[i], want[n + i], want[2 * n + i])
        check(bls.g1_eq(pt, bls.g1_dbl(ps[i])), "g1_ref.dbl wrong")
    odd_pts = glv.point_run(random.Random(0xDB1), ODD_LANES)
    odd = odd_dbl_entry(g1.g1_dbl, g1_ref.dbl, g1.g1_coords,
                        lambda pts: g1.g1_pack(pts, dev), ref_pts, odd_pts,
                        bls.G1_INF, (2,), 144, MULS_DBL, 100)
    report["g1_dbl"] = dict(
        lanes=n, ok=got == want and odd["ok"], max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g1.g1_dbl(kp), 100),
        plain_ms=cuda_ms(lambda: g1_ref.dbl(rp), 3),
        bound=bound(2 * 144 * n, n * MULS_DBL * OPS_PER_FIELD_MUL), odd=odd,
    )
    got = g1.g1_coords(g1.g1_add(kp, kq))
    want = g1.g1_coords(g1_ref.add_incomplete(rp, rq).cpu())
    check(want[2 * n + 7] == 0, "g1_ref.add: p == q must give Z = 0")
    for i in range(0, n, 997):
        pt = (want[i], want[n + i], want[2 * n + i])
        check(bls.g1_eq(pt, bls.g1_add(ps[i], qs[i])), "g1_ref.add wrong")
    report["g1_add"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g1.g1_add(kp, kq), 100),
        plain_ms=cuda_ms(lambda: g1_ref.add_incomplete(rp, rq), 3),
        bound=bound(3 * 144 * n, n * MULS_ADD * OPS_PER_FIELD_MUL),
    )

    # (14) the table build at the TPKE era's joined lanes [u | y | u |
    # phi(u)] (g1.tpke_lanes, 16,384 lanes), against the plain chain of
    # one doubling and 13 adds
    lanes = g1.tpke_lanes(rng, slots=n // 128)
    m = len(lanes)
    kl, rl = g1.g1_pack(lanes, dev), ref_pts(lanes)
    ktab = g1.build_table(kl)
    rtab, plain_ms = cuda_ms_once(lambda: g1_ref.build_table(rl))
    got = [g1.g1_coords(ktab[k]) for k in range(glv.TABLE)]
    want = [g1.g1_coords(rtab[k].cpu()) for k in range(glv.TABLE)]
    for k in (1, 2, 3, 15):
        for i in (0, m // 4, m - 1):  # a u, a y and a phi(u) lane
            pt = (want[k][i], want[k][m + i], want[k][2 * m + i])
            check(bls.g1_eq(pt, bls.g1_mul(lanes[i], k)),
                  "g1_ref.build_table wrong")
    report["g1_table"] = dict(
        lanes=m, ok=got == want,
        max_abs_err=max(max_err(a, b) for a, b in zip(got, want)),
        ms=cuda_ms(lambda: g1.build_table(kl), 10), plain_ms=plain_ms,
        bound=bound((1 + glv.TABLE) * 144 * m, m * MULS_TABLE * OPS_PER_FIELD_MUL),
    )
    del got, want

    # (4) msm_scan at the TPKE era's joined layout: 32 windows x 16,384
    # lanes, digits [rlc32 | rlc32 | lag1 | lag2] (g1.tpke_digits), over
    # the tables the card and the plain chain just built from those lanes
    scan = (g1.msm_scan, g1_ref.msm_scan, g1.g1_coords)
    main = scan_entry(*scan, ktab, rtab, g1.tpke_digits(rng, slots=n // 128).to(dev),
                      MULS_DBL, MULS_ADD, 144, "tpke joined", 10)
    del rtab

    # and the random-digit kernel check: 32 windows over a host-built table
    # k*P; every 61st lane has all-zero digits and must come back flagged
    nwin = glv.W128
    table_pts = [[bls.G1_INF] * n, ps]
    for _ in range(glv.TABLE - 2):
        table_pts.append([bls.g1_add(a, b) for a, b in zip(table_pts[-1], ps)])
    ktab = torch.stack([g1.g1_pack(row, dev) for row in table_pts])
    rtab = torch.stack([ref_pts(row) for row in table_pts])
    scalars = [rng.randrange(1 << 128) for _ in range(n)]
    for i in range(0, n, 61):
        scalars[i] = 0
    scalars[1] = 5  # leading zero windows, then one nonzero digit
    digits = g1.digits_col(scalars, nwin, dev)
    chk = scan_entry(*scan, ktab, rtab, digits, MULS_DBL, MULS_ADD, 144,
                     "random", 5)
    want, rfl = chk.pop("want"), chk.pop("flags")
    main.pop("want"), main.pop("flags")
    check(bool(rfl[0]) and not bool(rfl[1]), "zero-digit lane flags wrong")
    for i in (1, 2, 3, n // 2):
        pt = (want[i], want[n + i], want[2 * n + i])
        check(bls.g1_eq(pt, bls.g1_mul(ps[i], scalars[i])), "g1_ref.msm wrong")
    report["g1_msm_scan"] = dict(chk, ok=main["ok"] and chk["ok"], main=main)

    # (17) g1_mont on a (37, 8192) buffer with a flag row (the fetch's
    # layout), and into form on the coin era's (72, 4096) G2 pack
    report["g1_mont"] = g1_mont_entry(rng, dev, n)
    report.update(check_fixed_base_kernels(rng, dev))
    report.update(check_g2_kernels(rng, dev))
    report.update(check_secp_kernels(rng, dev))
    report.update(check_rs_kernels(rng, dev))
    for name, r in report.items():
        report_line(name, r)
    bad = [name for name, r in report.items() if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    return report


# the fixed-base kernels' shapes: N validators' keys (K = N) and the era's
# N slots x N key lanes; N=64 is the GLV era's, N=256 the largest era
FIXED_ERAS = (64, 256)


def check_fixed_base_kernels(rng: random.Random, dev):
    """The GLV era's two fixed-base kernels against g1_ref at N=64's and
    N=256's shapes: g1_fixed_tables over the N keys (every entry of the 16
    x 16 tables, and entries (w, d) = (0, 1), (7, 15), (15, 1), (15, 15) of
    three keys against the host's d * 16^(15 - w) * Y), and g1_fixed_scan
    over the era's N x N key lanes with 64-bit RLC digits, a lane with zero digits
    between nonzero ones and an all-zero lane among them. Exact:
    coordinates mod p and flags. The N=64 numbers are the entries' own,
    N=256's under `n256`."""
    import torch

    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.ops import g1, g1_ref, glv

    report = {}
    for k in FIXED_ERAS:
        keys = glv.point_run(rng, k)
        kk = g1.g1_pack(keys, dev)
        kt = g1.fixed_tables(kk)
        rt, plain_ms = cuda_ms_once(lambda: g1_ref.fixed_tables(
            torch.from_numpy(g1_ref.points_to_limbs(keys)).to(dev)))

        def window(tables, w):
            if tables.dtype == torch.int32:
                return g1.fp_decode(tables[w].reshape(glv.TABLE * 36, k))
            limbs = tables[w].reshape(3 * glv.TABLE, 44, k).permute(1, 0, 2)
            return g1_ref.limbs_to_ints(limbs.reshape(44, -1).cpu().numpy())

        diffs = [max_err(window(kt, w), window(rt, w)) for w in range(glv.W64)]
        for w, d in ((0, 1), (7, 15), (15, 1), (15, 15)):
            co = g1.g1_coords(kt[w, d])
            for i in (0, k // 2, k - 1):
                check(bls.g1_eq((co[i], co[k + i], co[2 * k + i]),
                                bls.g1_mul(keys[i], d * 16 ** (glv.W64 - 1 - w))),
                      f"g1_fixed_tables entry ({w}, {d}) of key {i} != the host's")
        # the function's own work: the 60 doublings of the chain and a
        # table a window; the kernel's tables (3 doublings and 11 adds of
        # 16 products, 197) cost 6 products a window more than the chain
        # of one doubling and 13 adds sharing the point's z powers (191)
        products = k * (MULS_DBL * glv.WINDOW * (glv.W64 - 1) + glv.W64 * MULS_TABLE)
        tables_bytes = glv.W64 * glv.TABLE * 144 * k
        tab = dict(
            lanes=glv.W64 * k, layout=f"N={k} keys", ok=max(diffs) == 0,
            max_abs_err=max(diffs), ms=cuda_ms(lambda: g1.fixed_tables(kk), 10),
            plain_ms=plain_ms,
            bound=bound(144 * k + tables_bytes, products * OPS_PER_FIELD_MUL),
        )

        n = k * k  # N slots x N key lanes
        rlc = [rng.randrange(1, 1 << 64) for _ in range(n)]
        rlc[0] = 0  # an all-zero lane
        rlc[1] = 0xF00000000000000F  # zero digits between nonzero ones
        digits = g1.digits_col(rlc, glv.W64, dev)
        acc, fl = g1.fixed_scan(kt, digits, k)
        (racc, rfl), plain_ms = cuda_ms_once(lambda: g1_ref.fixed_scan(rt, digits, k))
        got, want = g1.g1_coords(acc), g1.g1_coords(racc.cpu())
        flags_ok = fl.cpu().tolist() == rfl.cpu().tolist() == [c == 0 for c in rlc]
        for j in (1, 2, n - 1):
            check(bls.g1_eq((want[j], want[n + j], want[2 * n + j]),
                            bls.g1_mul(keys[j % k], rlc[j])),
                  f"g1_ref.fixed_scan lane {j} != the host's rlc * Y")
        nz = digits.cpu() != 0
        adds = int(nz.sum()) - int(nz.any(0).sum())
        scan = dict(
            lanes=n, windows=glv.W64, layout=f"N={k} key lanes, 4 sub-lanes a lane",
            ok=got == want and flags_ok, max_abs_err=max_err(got, want),
            ms=cuda_ms(lambda: g1.fixed_scan(kt, digits, k, digits_checked=True), 20),
            plain_ms=plain_ms,
            bound=bound(tables_bytes + 4 * glv.W64 * n + 145 * n,
                        adds * MULS_ADD * OPS_PER_FIELD_MUL),
        )
        del rt, racc, got, want
        if not report:
            report = {"g1_fixed_tables": tab, "g1_fixed_scan": scan}
        else:
            for name, r in (("g1_fixed_tables", tab), ("g1_fixed_scan", scan)):
                report[name]["ok"] = report[name]["ok"] and r["ok"]
                report[name][f"n{k}"] = r
    return report


def check_g2_kernels(rng: random.Random, dev):
    """The four G2 kernels against g2_ref: g2_dbl and g2_add at 8192 lanes,
    the table build at the coin era's 4096 signature lanes, the scan with
    64 windows at the coin era's layout and at random digits."""
    import torch

    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.ops import g2, g2_ref, glv

    n = KERNEL_LANES
    report = {}

    def ref_pts(points):
        return torch.from_numpy(g2_ref.points_to_limbs(points)).to(dev)

    # (5) g2_dbl and (6) g2_add on n Jacobian points (Z != 1), lane 7 of the
    # add holding p == q (Z = 0 on both sides); the doubling also at
    # ODD_LANES with infinity lanes
    ps = glv.point_run(rng, n, bls.g2_mul, bls.g2_add, bls.G2_GEN)
    qs = glv.point_run(rng, n, bls.g2_mul, bls.g2_add, bls.G2_GEN)
    qs[7] = ps[7]
    kp, kq = g2.g2_pack(ps, dev), g2.g2_pack(qs, dev)
    rp, rq = ref_pts(ps), ref_pts(qs)
    got = g2.g2_coords(g2.g2_dbl(kp))
    want = g2.g2_coords(g2_ref.dbl(rp).cpu())
    for i in range(0, n, 997):
        check(bls.g2_eq(g2_lane(want, i, n), bls.g2_dbl(ps[i])), "g2_ref.dbl wrong")
    odd_pts = glv.point_run(random.Random(0xDB2), ODD_LANES,
                            bls.g2_mul, bls.g2_add, bls.G2_GEN)
    odd = odd_dbl_entry(g2.g2_dbl, g2_ref.dbl, g2.g2_coords,
                        lambda pts: g2.g2_pack(pts, dev), ref_pts, odd_pts,
                        bls.G2_INF, (4, 5), 288, MULS_DBL2, 50)
    report["g2_dbl"] = dict(
        lanes=n, ok=got == want and odd["ok"], max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g2.g2_dbl(kp), 50),
        plain_ms=cuda_ms(lambda: g2_ref.dbl(rp), 3),
        bound=bound(2 * 288 * n, n * MULS_DBL2 * OPS_PER_FIELD_MUL), odd=odd,
    )
    got = g2.g2_coords(g2.g2_add(kp, kq))
    want = g2.g2_coords(g2_ref.add_incomplete(rp, rq).cpu())
    check(want[4 * n + 7] == want[5 * n + 7] == 0, "g2_ref.add: p == q must give Z = 0")
    for i in range(0, n, 997):
        check(bls.g2_eq(g2_lane(want, i, n), bls.g2_add(ps[i], qs[i])),
              "g2_ref.add wrong")
    report["g2_add"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g2.g2_add(kp, kq), 50),
        plain_ms=cuda_ms(lambda: g2_ref.add_incomplete(rp, rq), 3),
        bound=bound(3 * 288 * n, n * MULS_ADD2 * OPS_PER_FIELD_MUL),
    )

    # (13) the G2 table build at the coin era's signature lanes: 64 coins x
    # 64 signers, the first 22 of each coin live and the others infinity
    # (0, 1, 0), whose Z = 0 every entry keeps; against the plain chain of
    # one doubling and 13 adds
    m = COIN_LANES
    lanes = g2.coin_lanes(rng, coins=m // 64, live=LIVE)
    kl, rl = g2.g2_pack(lanes, dev), ref_pts(lanes)
    ktab = g2.build_table2(kl)
    rtab, plain_ms = cuda_ms_once(lambda: g2_ref.build_table(rl))
    got = [g2.g2_coords(ktab[k]) for k in range(glv.TABLE)]
    want = [g2.g2_coords(rtab[k].cpu()) for k in range(glv.TABLE)]
    for k in (1, 2, 3, 15):
        check(bls.g2_eq(g2_lane(want[k], 0, m), bls.g2_mul(lanes[0], k)),
              "g2_ref.build_table wrong")
        check(want[k][4 * m + LIVE] == want[k][5 * m + LIVE] == 0,
              "g2_ref.build_table: an infinity lane must keep Z = 0")
    del rtab
    report["g2_table"] = dict(
        lanes=m, ok=got == want,
        max_abs_err=max(max_err(a, b) for a, b in zip(got, want)),
        ms=cuda_ms(lambda: g2.build_table2(kl), 10), plain_ms=plain_ms,
        bound=bound((1 + glv.TABLE) * 288 * m, m * MULS_TABLE2 * OPS_PER_FIELD_MUL),
    )

    # (7) g2_msm_scan over a host-built table k*P: at the coin era's layout
    # (g2.coin_digits: [rlc64 | lag64], 48 leading zero windows on
    # the RLC half, 22 live lanes of each 64 on both halves), then at the
    # random-digit kernel check (64 windows of random digits; every 61st lane
    # all zero and flagged)
    scan = (g2.msm2_scan, g2_ref.msm_scan, g2.g2_coords)
    nwin = 64
    table_pts = [[bls.G2_INF] * n, ps]
    for _ in range(glv.TABLE - 2):
        table_pts.append([bls.g2_add(a, b) for a, b in zip(table_pts[-1], ps)])
    ktab = torch.stack([g2.g2_pack(row, dev) for row in table_pts])
    rtab = torch.stack([ref_pts(row) for row in table_pts])
    del table_pts
    coin = g2.coin_digits(rng, coins=n // 128).to(dev)
    main = scan_entry(*scan, ktab, rtab, coin, MULS_DBL2, MULS_ADD2, 288,
                      "coin", 5)
    main.pop("want"), main.pop("flags")
    scalars = [rng.randrange(1 << 256) for _ in range(n)]
    for i in range(0, n, 61):
        scalars[i] = 0
    scalars[1] = 5  # leading zero windows, then one nonzero digit
    digits = torch.from_numpy(glv.digits_col(scalars, nwin)).to(dev)
    chk = scan_entry(*scan, ktab, rtab, digits, MULS_DBL2, MULS_ADD2, 288,
                     "random", 3)
    want, rfl = chk.pop("want"), chk.pop("flags")
    check(bool(rfl[0]) and not bool(rfl[1]), "zero-digit lane flags wrong")
    for i in (1, 2, n // 2):
        check(bls.g2_eq(g2_lane(want, i, n), bls.g2_mul(ps[i], scalars[i])),
              "g2_ref.msm wrong")
    del rtab
    report["g2_msm_scan"] = dict(chk, ok=main["ok"] and chk["ok"], main=main)
    return report


def g2_lane(coords, i: int, n: int):
    """Lane i of g2_coords over n lanes -> an oracle G2 Jacobian tuple."""
    return tuple((coords[j * n + i], coords[(j + 1) * n + i]) for j in (0, 2, 4))


def check_secp_kernels(rng: random.Random, dev):
    """The seven secp256k1 kernels against secp_ref at the recover path's
    shapes: 8192 lanes (one 4096-signature chunk), the table build at a
    chunk's [R_i, G] lanes, the scan with 64 windows of random digits and at
    the chunk's layout, the square root at 16384 lanes and at the
    recovery's 9,980, the Montgomery conversions on a chunk's fused
    buffer."""
    import torch

    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.ops import glv, secp, secp_ref

    n = KERNEL_LANES
    P = ecdsa.P
    report = {}

    def ref_fe(vals):
        return torch.from_numpy(secp_ref.ints_to_limbs(vals)).to(dev)

    def ref_pts(points):
        return torch.from_numpy(secp_ref.points_to_limbs(points)).to(dev)

    def affine(c, i):
        zi = pow(c[2 * n + i], -1, P)
        return (c[i] * zi * zi % P, c[n + i] * zi * zi * zi % P)

    # (8) secp_fp_mul, with 0, 1, p-1 and 2^256 mod p among the operands
    edge = [0, 1, P - 1, (1 << 256) % P]
    xs = edge + [rng.randrange(P) for _ in range(n - len(edge))]
    ys = list(reversed(edge)) + [rng.randrange(P) for _ in range(n - len(edge))]
    kx, ky = secp.fe_encode(xs, dev), secp.fe_encode(ys, dev)
    rx, ry = ref_fe(xs), ref_fe(ys)
    got = secp.fe_decode(secp.secp_fp_mul(kx, ky))
    want = secp_ref.limbs_to_ints(secp_ref.fp_mul(rx, ry).cpu().numpy())
    check(want == [x * y % P for x, y in zip(xs, ys)], "secp_ref.fp_mul wrong")
    report["secp_fp_mul"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: secp.secp_fp_mul(kx, ky), 200),
        plain_ms=cuda_ms(lambda: secp_ref.fp_mul(rx, ry), 5),
        bound=bound(3 * 32 * n, n * OPS_PER_SECP_MUL),
    )

    # (9) secp_dbl on n affine points, and at ODD_LANES with infinity lanes;
    # (10) secp_add on the doubled points (Z != 1) and n more, lane 7
    # holding p == q (Z = 0 on both sides)
    secp_run = (ecdsa._mul, ecdsa._add, ecdsa.G, ecdsa.N)
    ps = glv.point_run(rng, n, *secp_run)
    qs = glv.point_run(rng, n, *secp_run)
    qs[7] = ecdsa._add(ps[7], ps[7])
    kp, kq = secp.pt_pack(ps, dev), secp.pt_pack(qs, dev)
    rp, rq = ref_pts(ps), ref_pts(qs)
    kd, rd = secp.secp_dbl(kp), secp_ref.dbl(rp)
    got, want = secp.pt_coords(kd), secp_ref.coords(rd.cpu())
    for i in range(0, n, 997):
        check(affine(want, i) == ecdsa._add(ps[i], ps[i]), "secp_ref.dbl wrong")
    odd_pts = glv.point_run(random.Random(0xDB3), ODD_LANES, *secp_run)
    odd = odd_dbl_entry(secp.secp_dbl, secp_ref.dbl, secp.pt_coords,
                        lambda pts: secp.pt_pack(pts, dev), ref_pts, odd_pts,
                        None, (2,), 96, MULS_DBL, 100, OPS_PER_SECP_MUL)
    report["secp_dbl"] = dict(
        lanes=n, ok=got == want and odd["ok"], max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: secp.secp_dbl(kp), 100),
        plain_ms=cuda_ms(lambda: secp_ref.dbl(rp), 3),
        bound=bound(2 * 96 * n, n * MULS_DBL * OPS_PER_SECP_MUL), odd=odd,
    )
    got = secp.pt_coords(secp.secp_add(kd, kq))
    want = secp_ref.coords(secp_ref.add_incomplete(rd, rq).cpu())
    check(want[2 * n + 7] == 0, "secp_ref.add: p == q must give Z = 0")
    for i in range(1, n, 997):
        check(affine(want, i) == ecdsa._add(ecdsa._add(ps[i], ps[i]), qs[i]),
              "secp_ref.add wrong")
    report["secp_add"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: secp.secp_add(kd, kq), 100),
        plain_ms=cuda_ms(lambda: secp_ref.add_incomplete(rd, rq), 3),
        bound=bound(3 * 96 * n, n * MULS_ADD * OPS_PER_SECP_MUL),
    )

    # (11) secp_msm_scan: 64 windows over a host-built table k*P; every 61st
    # lane has all-zero digits and must come back flagged
    nwin = glv.W256
    table_pts = [[None] * n, ps]
    for _ in range(glv.TABLE - 2):
        table_pts.append([ecdsa._add(a, b) for a, b in zip(table_pts[-1], ps)])
    ktab = torch.stack([secp.pt_pack(row, dev) for row in table_pts])
    rtab = torch.stack([ref_pts(row) for row in table_pts])
    del table_pts
    scalars = [rng.randrange(1 << 256) for _ in range(n)]
    for i in range(0, n, 61):
        scalars[i] = 0
    scalars[1] = 5  # leading zero windows, then one nonzero digit
    digits = secp.digits_col(scalars, dev)
    scan = (secp.msm_scan, secp_ref.msm_scan, secp.pt_coords)
    chk = scan_entry(*scan, ktab, rtab, digits, MULS_DBL, MULS_ADD, 96,
                     "random", 5, OPS_PER_SECP_MUL)
    want, rfl = chk.pop("want"), chk.pop("flags")
    check(bool(rfl[0]) and not bool(rfl[1]), "zero-digit lane flags wrong")
    for i in (1, 2, 3, n // 2):
        check(affine(want, i) == ecdsa._mul(ps[i], scalars[i]), "secp_ref.msm wrong")
    del rtab

    # (15) the table build at the recovery's layout: one 4096-signature
    # chunk, [R_i, G] interleaved (secp.recover_layout, 8192 affine lanes),
    # against the plain chain of one doubling and 13 adds
    pts, rdigits = secp.recover_layout(rng, n // 2)
    kl, rl = secp.pt_pack(pts, dev), ref_pts(pts)
    ktab = secp.build_table(kl)
    rtab, plain_ms = cuda_ms_once(lambda: secp_ref.build_table(rl))
    got = [secp.pt_coords(ktab[k]) for k in range(glv.TABLE)]
    want = [secp_ref.coords(rtab[k].cpu()) for k in range(glv.TABLE)]
    for k in (1, 2, 3, 15):
        for i in (0, 1, n - 2):  # R_0, G, R_4095
            check(affine(want[k], i) == ecdsa._mul(pts[i], k),
                  "secp_ref.build_table wrong")
    report["secp_table"] = dict(
        lanes=n, ok=got == want,
        max_abs_err=max(max_err(a, b) for a, b in zip(got, want)),
        ms=cuda_ms(lambda: secp.build_table(kl), 20), plain_ms=plain_ms,
        bound=bound((1 + glv.TABLE) * 96 * n, n * MULS_TABLE * OPS_PER_SECP_MUL),
    )
    del got, want

    # and the scan at the recovery's layout: the chunk's full-width u1, u2
    # over the tables the card and the plain chain just built
    main = scan_entry(*scan, ktab, rtab, rdigits.to(dev), MULS_DBL, MULS_ADD,
                      96, "recover", 5, OPS_PER_SECP_MUL)
    main.pop("want"), main.pop("flags")
    del rtab
    report["secp_msm_scan"] = dict(chk, ok=main["ok"] and chk["ok"], main=main)

    # (12) secp_sqrt on plain words at 16384 lanes and at the recovery's
    # 9,980 (no padding): random x (about half non-residues), 0, 1, p - 1
    # and G's x among them, every lane against the plain version
    sqrt_runs = {layout: sqrt_entry(rng, dev, m, layout)
                 for layout, m in (("check", SQRT_LANES), ("recover", RECOVER_SQRT_LANES))}
    report["secp_sqrt"] = dict(sqrt_runs["check"], main=sqrt_runs["recover"],
                               ok=all(r["ok"] for r in sqrt_runs.values()))

    # (16) secp_mont on a (25, 8192) buffer (a chunk's fused layout)
    report["secp_mont"] = mont_entry(rng, dev, n)
    return report


def mont_entry(rng: random.Random, dev, n: int) -> dict:
    """secp_mont on a (25, n) buffer, 3 coordinates of random words (0, 1
    and p - 1 among them) and a flag row, out of Montgomery form and into
    it, each against the plain version bit for bit and against Python ints,
    the flag row copied; both directions timed, the bound by bytes."""
    import numpy as np
    import torch

    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.ops import secp, secp_ref

    P, r = ecdsa.P, 1 << 256
    vals = [0, 1, P - 1] + [rng.randrange(P) for _ in range(3 * n - 3)]
    words = np.concatenate([secp._words(vals[c * n : (c + 1) * n]) for c in range(3)])
    flags = np.array([rng.randrange(2) for _ in range(n)], np.int32)[None]
    buf = torch.from_numpy(np.concatenate([words.view(np.int32), flags])).to(dev)
    runs = {}
    for into, want in ((False, [v * pow(r, -1, P) % P for v in vals]),
                       (True, [v * r % P for v in vals])):
        out = secp.mont_convert(buf, into)
        plain, plain_ms = cuda_ms_once(
            lambda into=into: secp_ref.mont_mul_words(buf, secp._R2 if into else 1))
        got = secp._download_words(out[:-1])
        runs[into] = dict(
            ok=torch.equal(out, plain) and got == want and torch.equal(out[-1], buf[-1]),
            max_abs_err=max_err(got, want), plain_ms=plain_ms,
            ms=cuda_ms(lambda into=into: secp.mont_convert(buf, into), 200))
    out_, in_ = runs[False], runs[True]
    return dict(
        lanes=n, rows=int(buf.shape[0]), ok=out_["ok"] and in_["ok"],
        max_abs_err=max(out_["max_abs_err"], in_["max_abs_err"]),
        ms=out_["ms"], plain_ms=out_["plain_ms"],
        into_ms=in_["ms"], into_plain_ms=in_["plain_ms"],
        bound=bound(2 * buf.numel() * 4, 3 * n * MONT_WORD_PRODUCTS * 2),
    )


def g1_mont_entry(rng: random.Random, dev, n: int) -> dict:
    """g1_mont on a (37, n) buffer, 3 coordinates of random words (0, 1 and
    p - 1 among them) and a flag row, out of Montgomery form, into it and
    by beta (the first coordinate), each against the plain version bit for
    bit and against Python ints, the flag row copied; and into form at the
    main path's largest conversion, the coin era's (72, n / 2) G2 signature
    pack. Each timed, the bound by bytes."""
    import numpy as np
    import torch

    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.ops import g1, g1_ref, glv

    P, r = bls.P, 1 << 384

    def buffer(coords: int, lanes: int, flag_row: bool):
        vals = [0, 1, P - 1] + [rng.randrange(P) for _ in range(coords * lanes - 3)]
        rows = [g1._words(vals[c * lanes : (c + 1) * lanes]).view(np.int32)
                for c in range(coords)]
        if flag_row:
            rows.append(np.array([rng.randrange(2) for _ in range(lanes)], np.int32)[None])
        return vals, torch.from_numpy(np.concatenate(rows)).to(dev)

    def ints(t):
        return g1._from_words(t.cpu().numpy().view(np.uint32))

    def run(buf, vals, op, factor, want):
        out = g1._mont(buf, op)
        plain, plain_ms = cuda_ms_once(lambda: g1_ref.mont_mul_words(buf, factor))
        coords = buf.shape[0] // g1.NL * g1.NL
        got = ints(out[:coords])
        return dict(
            ok=torch.equal(out, plain) and got == want
            and torch.equal(out[coords:], buf[coords:]),
            max_abs_err=max_err(got, want), plain_ms=plain_ms,
            ms=cuda_ms(lambda: g1._mont(buf, op), 200),
            bound=bound(2 * buf.numel() * 4,
                        coords // g1.NL * buf.shape[1] * 2
                        * (G1_MONT_WORD_PRODUCTS if op == g1._MONT_OUT
                           else OPS_PER_FIELD_MUL // 2)))

    vals, buf = buffer(3, n, True)
    out_ = run(buf, vals, g1._MONT_OUT, 1, [v * pow(r, -1, P) % P for v in vals])
    in_ = run(buf, vals, g1._MONT_INTO, g1._R2, [v * r % P for v in vals])
    x = buf[: g1.NL].contiguous()
    beta = run(x, vals[:n], g1._MONT_BETA, g1._BETA_R,
               [glv.BETA * v % P for v in vals[:n]])  # x beta R / R
    vals2, buf2 = buffer(6, n // 2, False)
    main = run(buf2, vals2, g1._MONT_INTO, g1._R2, [v * r % P for v in vals2])
    runs = (out_, in_, beta, main)
    return dict(
        lanes=n, rows=int(buf.shape[0]), ok=all(x["ok"] for x in runs),
        max_abs_err=max(x["max_abs_err"] for x in runs),
        ms=out_["ms"], plain_ms=out_["plain_ms"], bound=out_["bound"],
        into_ms=in_["ms"], into_plain_ms=in_["plain_ms"], beta_ms=beta["ms"],
        main=dict(main, layout="coin G2 pack, into form", lanes=n // 2),
    )


def sqrt_entry(rng: random.Random, dev, m: int, layout: str) -> dict:
    """The card's sqrt on m lanes of plain words against secp_ref.sqrt on
    every lane, both timed, with its bound a lane: the product into
    Montgomery form, y2's squaring and product, SQRT_CHAIN's squarings and
    products (each squaring at its own cost), the reduction out of form."""
    import torch

    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.ops import secp, secp_ref

    P = ecdsa.P
    non_residue = next(x for x in range(2, 100)
                       if pow((x ** 3 + 7) % P, (P - 1) // 2, P) == P - 1)
    xs = [ecdsa.GX, 0, 1, P - 1, non_residue] + [rng.randrange(P) for _ in range(m - 5)]
    kx = secp._upload_words(secp._words(xs), dev)
    rx = torch.from_numpy(secp_ref.ints_to_limbs(xs)).to(dev)
    got = secp._download_words(secp.sqrt(kx))
    want, plain_ms = cuda_ms_once(lambda: secp_ref.sqrt(rx))
    want = secp_ref.limbs_to_ints(want.cpu().numpy())
    check(want[0] in (ecdsa.GY, P - ecdsa.GY), "secp_ref.sqrt wrong at G")
    for i in range(1, m, 4099):
        check(want[i] == pow((xs[i] ** 3 + 7) % P, (P + 1) // 4, P),
              "secp_ref.sqrt wrong")
    sqrs = 1 + sum(s for s, _ in secp.SQRT_CHAIN)
    muls = 2 + sum(k is not None for _, k in secp.SQRT_CHAIN)
    ops = sqrs * OPS_PER_SECP_SQR + muls * OPS_PER_SECP_MUL + 2 * MONT_WORD_PRODUCTS
    return dict(
        layout=layout, lanes=m, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: secp.sqrt(kx), 20), plain_ms=plain_ms,
        bound=bound(2 * 32 * m, m * ops),
    )


# ---------------------------------------------------------------------------
# phase 3: the N=64 era through GpuBackend
# ---------------------------------------------------------------------------


def make_era(n: int, seed: int):
    """Trusted dealer, one 32-byte message per slot, n x n decryption shares
    (U^{x_i}, on the native host library as a validator computes them) and
    the slots' EraSlotJobs (host only; no kernel involved)."""
    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto import tpke
    from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob
    from lachain_tpu_torch.crypto.native_backend import NativeBackend

    f = (n - 1) // 3
    dealer = tpke.TpkeTrustedKeyGen(n, f, SeededRng(seed))
    privs = [dealer.private_key(i) for i in range(n)]
    chosen = list(range(f + 1))
    lag = [0] * n
    for i, c in zip(chosen, bls.fr_lagrange_coeffs([i + 1 for i in chosen], at=0)):
        lag[i] = c
    msgs = [bytes([(s * 7 + i) % 256 for i in range(32)]) for s in range(n)]
    cts = [dealer.pub.encrypt(msg, s, SeededRng(seed * 1000 + s))
           for s, msg in enumerate(msgs)]
    native = NativeBackend()
    shares = [tpke.decrypt_shares_batch(p, cts, native) for p in privs]
    jobs = [EraSlotJob([shares[i][s].ui for i in range(n)], list(lag),
                       tpke._hash_uv_to_g2(ct.u, ct.v), ct.w) for s, ct in enumerate(cts)]
    return dealer, cts, msgs, jobs


def profile_device(run, warm=None) -> dict:
    """{kernel: [device ms, launches]} of one call of run() from
    torch.profiler; device work that is not one of the twenty-one kernels
    (copies, cat, where) is summed under "torch". A trace loses the first
    device activities of its session (a trace of the recover path lacked
    its first three launches), so run() (or `warm()`, where a path runs
    once) goes twice under the profiler's warm-up steps, whose events are
    dropped, and run() once under its active step, which is what is
    summed. The step's own span ("ProfilerStep*")
    covers the whole call and is left out. Each step idles TRACE_PAD_S on
    the host before run() and after it has synchronized, so that no launch
    lies near the edge of its step's window: the profiler drops a device
    activity whose time, mapped from the card's clock to the host's, falls
    outside the window, and unpadded traces lost launches made just after
    a window opened."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
        for step in range(3):
            time.sleep(TRACE_PAD_S)
            (run if warm is None or step == 2 else warm)()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
            prof.step()
    out: dict = {}
    for e in traced[0]:
        t = getattr(e, "self_device_time_total", 0) or 0
        name = kernel_of(e.key)
        # a kernel's launches count whatever device time the trace gives them
        if e.key.startswith("ProfilerStep") or (t <= 0 and name == "torch"):
            continue
        acc = out.setdefault(name, [0.0, 0])
        acc[0] += t / 1e3
        acc[1] += e.count
    return out


def profile_launches(run, want: dict, label: str, tries: int = 5) -> dict:
    """profile_device(run), again (at most `tries` traces) while its trace
    lacks some of the `want` {kernel: launches} that run() makes: traces
    of this card's profiler without the padding of profile_device lost a
    flush's first launch, one or all ten launches of a kernel's timed use,
    and in one run one of ten in three traces in a row. Each loss is
    logged, and the phase fails when the last trace still lacks some: no
    time is taken from a partial trace."""
    for i in range(tries):
        by_kernel = profile_device(run)
        got = {k: by_kernel.get(k, [0.0, 0])[1] for k in want}
        if got == want:
            break
        log(f"{label}: the trace lost device activities (trace {i + 1} of {tries}): "
            f"{got} != {want}")
    check(got == want, f"{label}: {tries} traces lacked launches: {got} != {want}")
    return by_kernel


def kernel_of(key: str) -> str:
    """The kernel of a profiler key, templated or not
    ("(anonymous namespace)::msm_scan_kernel<4>(...)" -> "msm_scan_kernel"),
    or "torch" for device work that is none of the twenty-one."""
    m = re.search(r"::(\w+)[<(]", key)
    return m[1] if m and m[1] in KERNEL_NAMES else "torch"


def check_traced(label: str, by_kernel: dict, launches: dict, names) -> None:
    """Fail unless the profiled run traced as many launches of each of
    `names` as the counted main-path run made."""
    traced = {k: by_kernel.get(KERNEL_OF[k], [0, 0])[1] for k in names}
    counted = {k: launches[k] for k in names}
    check(traced == counted,
          f"{label}: traced launches {traced} != counted {counted} (trace: {by_kernel})")
    log(f"{label}: traced launches equal the counted ones {counted}")


def reset_counts() -> None:
    """Set every kernel's launch count and every host recompute count to 0."""
    from lachain_tpu_torch.ops import g1, g2, rs_batch, secp, verify

    g1.reset_launches()
    g2.reset_launches()
    secp.reset_launches()
    rs_batch.reset_launches()
    verify.reset_escapes()


def read_launches() -> dict:
    from lachain_tpu_torch.ops import g1, g2, rs_batch, secp

    return dict(g1.LAUNCHES, **g2.LAUNCHES, **secp.LAUNCHES, **rs_batch.LAUNCHES)


def check_no_escapes(label: str) -> None:
    """Fail if a result the card returned as infinity was recomputed on the
    host since the last reset_counts(): every answer must come from the
    kernels."""
    from lachain_tpu_torch.ops import verify

    check(not any(verify.ESCAPES.values()),
          f"{label}: host recomputes {verify.ESCAPES}")


def phase_line(t: dict) -> str:
    """Phases in seconds ({"pack_s": ...}) as "pack 1.23 ms, ..."."""
    return ", ".join(f"{k[:-2]} {v * 1e3:.2f} ms" for k, v in t.items())


def warm_summary(label: str, warm) -> None:
    """The phases of the warm run with the least wall time, in ms."""
    best = min(warm, key=lambda w: w["wall_s"])
    log(f"{label} warm (best of {len(warm)}): {phase_line(best)}")


def profile_phase(label: str, new_pipeline, run_era, launches: dict, names) -> dict:
    """Warm up, then split one era call by kernel. Each call runs
    run_era(pipeline) on a fresh new_pipeline(), so that, like the counted
    call (the backend's first era), it packs the keys: its launches are the
    counted call's (`launches` of `names`), which its trace must hold."""
    last = []

    def run():
        last[:] = [new_pipeline()]
        run_era(last[0])

    run()
    by_kernel = profile_launches(run, {KERNEL_OF[k]: launches[k] for k in names}, label)
    busy = sum(v[0] for v in by_kernel.values())
    log(f"{label} device phase by kernel (torch.profiler, ms, launches): "
        f"{by_kernel}; busy {busy:.3f} ms of device phase "
        f"{last[0].last_timings['device_s'] * 1e3:.3f} ms")
    return by_kernel


def run_tpke_path(seed: int, backend, dev, era):
    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto import tpke
    from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob
    from lachain_tpu_torch.ops.verify import GpuEraPipeline, HostEraPipeline

    dealer, cts, msgs, jobs = era
    n = len(jobs)
    vks = dealer.verification_keys

    def check_all(res, bad=()):
        for s, (ok, comb) in enumerate(res):
            if s in bad:
                check(ok is False and comb is None, f"slot {s} not isolated")
            else:
                check(ok, f"slot {s} failed verification")
                check(tpke.decrypt_with_combined(cts[s], comb) == msgs[s],
                      f"slot {s} plaintext not recovered")

    # the main-path run whose launches are counted
    reset_counts()
    t0 = time.perf_counter()
    res = backend.tpke_era_verify_combine(jobs, vks, SeededRng(seed + 1))
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    check_no_escapes("tpke era")
    check_all(res)
    got = {k: launches[k] for k in TPKE_LAUNCHES}
    check(got == TPKE_LAUNCHES, f"tpke era launches {got} != {TPKE_LAUNCHES}")
    log(f"era N={n}: {n} slots verified and decrypted; first era of the backend "
        f"(after the warmup) {cold_s:.3f} s; "
        f"launches {launches}; phases {backend.last_timings}")

    warm = []
    for r in range(2):
        t0 = time.perf_counter()
        res = backend.tpke_era_verify_combine(jobs, vks, SeededRng(seed + 2 + r))
        wall = time.perf_counter() - t0
        check_all(res)
        warm.append(dict(backend.last_timings, wall_s=wall))
        log(f"era warm {r}: wall {wall:.4f} s, pairing_s "
            f"{backend.last_timings['pairing_s']:.4f} s on the {backend.host_name} "
            f"host backend, phases {backend.last_timings}")

    # one poisoned share (a chosen lane) must isolate exactly its slot
    bad_slot = n // 4 + 1
    row = list(jobs[bad_slot].u_by_validator)
    row[3] = bls.g1_add(row[3], bls.G1_GEN)
    poisoned = list(jobs)
    poisoned[bad_slot] = EraSlotJob(row, jobs[bad_slot].lagrange_row,
                                    jobs[bad_slot].h, jobs[bad_slot].w)
    t0 = time.perf_counter()
    res = backend.tpke_era_verify_combine(poisoned, vks, SeededRng(seed + 9))
    check_all(res, bad=(bad_slot,))
    log(f"poisoned era: slot {bad_slot} isolated, others decrypt; "
        f"{time.perf_counter() - t0:.2f} s")

    # device time by kernel over one warm device phase (all 64 slots)
    y_points = [vk.y_i for vk in vks]
    slots = [(list(j.u_by_validator), list(j.lagrange_row)) for j in jobs]
    by_kernel = profile_phase("era", lambda: GpuEraPipeline(device=dev), lambda p: p.run_era(
        slots, y_points, SeededRng(seed + 4)), launches, tuple(TPKE_LAUNCHES))
    check_traced("era", by_kernel, launches, tuple(TPKE_LAUNCHES))
    check_host_pairing(backend, jobs, GpuEraPipeline(device=dev).run_era(
        slots, y_points, SeededRng(seed + 6))[0], bad_slot)

    # 4 slots against the host oracle pipeline, same seeded rng
    slots = slots[:4]
    dev_out, dev_rlc = GpuEraPipeline(device=dev).run_era(
        slots, y_points, SeededRng(seed + 5))
    host_out, host_rlc = HostEraPipeline().run_era(
        slots, y_points, SeededRng(seed + 5))
    check(dev_rlc == host_rlc, "rlc draws differ")
    for s, (a, b) in enumerate(zip(dev_out, host_out)):
        for x, y in zip(a, b):
            check(bls.g1_eq(x, y), f"slot {s} aggregate differs from host")
    log("4 slots equal to HostEraPipeline (u_agg, y_agg, combined, rlc)")
    return launches, warm


def check_host_pairing(backend, jobs, aggs, bad_slot: int) -> None:
    """The backend's host pairing (the native library) against the
    pure-Python HostBackend on the TPKE era's own grand check, the 2 pairs
    e(u_agg, H), e(-y_agg, W) of every slot (GpuBackend._dispatch_era_batch), and on
    the same pairs with slot `bad_slot`'s u_agg moved: both must hold the
    first and refuse the second. Both timed on the host clock."""
    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto.host import HostBackend

    pairs = [pair for job, agg in zip(jobs, aggs)
             for pair in ((agg[0], job.h), (bls.g1_neg(agg[1]), job.w))]
    poisoned = list(pairs)
    p, q = pairs[2 * bad_slot]
    poisoned[2 * bad_slot] = (bls.g1_add(p, bls.G1_GEN), q)
    python = HostBackend()
    for label, ps, want in (("grand check", pairs, True),
                            ("poisoned grand check", poisoned, False)):
        t0 = time.perf_counter()
        got = backend.pairing_check(ps)
        t1 = time.perf_counter()
        oracle = python.pairing_check(ps)
        t2 = time.perf_counter()
        check(got is want and oracle is want,
              f"{label}: {backend.host_name} {got}, python {oracle}, want {want}")
        log(f"host pairing, {label} of {len(ps)} pairs: {backend.host_name} "
            f"{got} in {t1 - t0:.4f} s, python HostBackend {oracle} in "
            f"{t2 - t1:.4f} s")


# ---------------------------------------------------------------------------
# phase 3: the N=64 era's TPKE flush through TpkeEraBatcher
# ---------------------------------------------------------------------------

# the flush's configurations: (name, max_slots_per_call, chunks)
FLUSH_CONFIGS = (("node", 512, 1), ("fleet", 512, 1), ("chunked", 16, 4))
# the timed configurations and their in-turn flushes at each depth
FLUSH_TIMED = ("node", "chunked")
FLUSH_ROUNDS = 6
CHUNK_PHASES = ("pack_s", "launch_s", "device_s", "wait_s", "fetch_s", "pairing_s")


def flush_launches(chunks: int) -> dict:
    """A counted flush's launches on a fresh backend: TPKE_LAUNCHES per
    chunk, but the tiled keys are packed into form once (one g1_mont) and
    kept for every later chunk of the same (key set, S)."""
    want = {k: v * chunks for k, v in TPKE_LAUNCHES.items()}
    want["g1_mont"] -= chunks - 1
    return want


def quartiles(xs) -> tuple:
    """(q1, median, q3) of xs, by the inclusive method."""
    import statistics

    q1, med, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return q1, med, q3


def run_flush_path(seed: int, backend, dev, era):
    """The N=64 era's slots through TpkeEraBatcher, in three configurations
    (FLUSH_CONFIGS): a node's 64 one-job submissions, the way HoneyBadger's
    era ticks submit them, at the reference default max_slots_per_call=512
    (one chunk); an in-process fleet, 64 validators each submitting the
    same 64 jobs with one slot poisoned, which dedupe to 64; and the node's
    submissions in chunks of 16 (4 chunks). Every callback result must
    equal backend.tpke_era_verify_combine on the same jobs, every honest
    slot decrypt and the poisoned one be isolated, with no host recompute;
    the counted flushes (fresh backends, depth 2) launch flush_launches(
    chunks), and a profiled flush of each traces as many. Then 6 flushes
    of the node and chunked configurations at depth 1 and depth 2, in
    turns, on one warm backend: the walls' quartiles, each chunk's median
    phases, and the card's idle share (1 - traced device time / median
    wall)."""
    from lachain_tpu_torch.consensus.crypto_batcher import TpkeEraBatcher
    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto import tpke
    from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob

    dealer, cts, msgs, jobs = era
    n = len(jobs)
    vks = dealer.verification_keys
    bad_slot = n // 4 + 1

    def copy(job):
        return EraSlotJob(list(job.u_by_validator), list(job.lagrange_row), job.h, job.w)

    row = list(jobs[bad_slot].u_by_validator)
    row[3] = bls.g1_add(row[3], bls.G1_GEN)
    poisoned = list(jobs)
    poisoned[bad_slot] = EraSlotJob(row, jobs[bad_slot].lagrange_row,
                                    jobs[bad_slot].h, jobs[bad_slot].w)
    # per configuration: its submissions, each a list of jobs
    subs = {
        "node": [[job] for job in jobs],
        "fleet": [[copy(job) for job in poisoned] for _ in range(n)],
        "chunked": [[job] for job in jobs],
    }
    bad = {"node": (), "fleet": (bad_slot,), "chunked": ()}
    t0 = time.perf_counter()
    want = {"node": backend.tpke_era_verify_combine(jobs, vks, SeededRng(seed + 30))}
    want["chunked"] = want["node"]
    want["fleet"] = backend.tpke_era_verify_combine(poisoned, vks, SeededRng(seed + 31))
    log(f"tpke_flush: synchronous era calls for the expected results "
        f"{time.perf_counter() - t0:.2f} s")

    def flush(name: str, b, rng, depth: int):
        """One flush of configuration `name` on backend b -> (batcher,
        results per submission)."""
        _, max_slots, _ = next(c for c in FLUSH_CONFIGS if c[0] == name)
        batcher = TpkeEraBatcher(b, rng, max_slots_per_call=max_slots, depth=depth)
        out = [None] * len(subs[name])
        for i, js in enumerate(subs[name]):
            batcher.submit(js, vks, lambda res, i=i: out.__setitem__(i, res))
        check(batcher.flush() == len(subs[name]), f"{name}: not every submission flushed")
        return batcher, out

    def check_results(name: str, out) -> None:
        per_job = [r for res in out for r in res]
        expect = want[name] * (len(per_job) // n)
        for i, ((ok, comb), (wok, wcomb)) in enumerate(zip(per_job, expect)):
            s = i % n
            check(ok is wok and (comb is None) == (wcomb is None)
                  and (comb is None or bls.g1_eq(comb, wcomb)),
                  f"{name}: job {i} differs from the synchronous era call")
            if s in bad[name]:
                check(ok is False and comb is None, f"{name}: slot {s} not isolated")
            elif i < n:
                check(ok and tpke.decrypt_with_combined(cts[s], comb) == msgs[s],
                      f"{name}: slot {s} not decrypted")

    # the counted flushes, each on a fresh backend at depth 2
    reset_counts()
    counted = {}
    for name, max_slots, chunks in FLUSH_CONFIGS:
        before = read_launches()
        t0 = time.perf_counter()
        batcher, out = flush(name, one_card_backend(dev), SeededRng(seed + 32), 2)
        wall = time.perf_counter() - t0
        after = read_launches()
        check_no_escapes(f"tpke_flush {name}")
        check_results(name, out)
        got = {k: after[k] - before[k] for k in TPKE_LAUNCHES}
        check(batcher.chunks == chunks, f"{name}: {batcher.chunks} chunks != {chunks}")
        check(got == flush_launches(chunks),
              f"{name}: launches {got} != {flush_launches(chunks)}")
        counted[name] = got
        t = batcher.last_timings
        log(f"tpke_flush {name}: {len(subs[name])} submissions, "
            f"{sum(map(len, subs[name]))} jobs, {batcher.slots_flushed} distinct "
            f"({batcher.deduped_slots} deduped in {t['dedupe_s'] * 1e3:.2f} ms), "
            f"{chunks} chunk(s) of <= {max_slots}; equal to the synchronous era, "
            f"slot(s) {list(bad[name])} isolated, the others decrypt; depth 2 on a "
            f"fresh backend {wall:.4f} s; launches {got}")
    launches = read_launches()

    names = tuple(TPKE_LAUNCHES)
    for name in counted:
        by_kernel = profile_launches(
            lambda: flush(name, one_card_backend(dev), SeededRng(seed + 33), 2),
            {KERNEL_OF[k]: counted[name][k] for k in names}, f"tpke_flush {name}")
        check_traced(f"tpke_flush {name} (depth 2)", by_kernel, counted[name], names)

    # in turns on one warm backend: depth 1 and depth 2, each timed config
    walls = {(c, d): [] for c in FLUSH_TIMED for d in (1, 2)}
    chunk_t = {(c, d): [] for c in FLUSH_TIMED for d in (1, 2)}
    warm = []
    for name in FLUSH_TIMED:  # the chunk shape's tiled keys, pinned buffers
        flush(name, backend, SeededRng(seed + 34), 2)
    for r in range(FLUSH_ROUNDS):
        for depth in ((1, 2) if r % 2 == 0 else (2, 1)):
            for name in FLUSH_TIMED:
                batcher, out = flush(name, backend, SeededRng(seed + 40 + r), depth)
                check_results(name, out)
                t = batcher.last_timings
                walls[(name, depth)].append(t["wall_s"])
                chunk_t[(name, depth)].append(t["chunks"])
                if name == "node" and depth == 2:
                    warm.append({k: v for k, v in t.items() if k != "chunks"})
    for name in FLUSH_TIMED:
        for depth in (1, 2):
            key = (name, depth)
            by_kernel = profile_device(lambda: flush(name, backend, SeededRng(seed + 35),
                                                     depth))
            busy = sum(v[0] for v in by_kernel.values())
            q1, med, q3 = quartiles(walls[key])
            chunks = len(chunk_t[key][0])
            phases = "; ".join(
                f"chunk {c}: " + ", ".join(
                    f"{p[:-2] if p != 'pairing_s' else 'grand check'} "
                    f"{quartiles([f[c][p] for f in chunk_t[key]])[1] * 1e3:.3f}"
                    for p in CHUNK_PHASES)
                for c in range(chunks))
            log(f"tpke_flush {name} depth {depth}: wall median {med * 1e3:.3f} ms "
                f"(q1 {q1 * 1e3:.3f}, q3 {q3 * 1e3:.3f}) over {FLUSH_ROUNDS} flushes in "
                f"turns; per chunk, median ms: {phases}; traced device time "
                f"{busy:.3f} ms, idle share {1 - busy / (med * 1e3):.4f}")
    return launches, warm


# ---------------------------------------------------------------------------
# phase 3: the N=64 TPKE era on the fixed-base key tables (GlvEraPipeline)
# ---------------------------------------------------------------------------

GLV_ROUNDS = 6


def run_glv_path(seed: int, backend, dev, era):
    """The N=64 era through GpuBackend(pipeline=GlvEraPipeline()): the
    counted run is a fresh backend's first era (GLV_FIRST: the key tables
    made) and a warm era (GLV_LAUNCHES); every slot decrypts, a poisoned
    share isolates its slot, 4 slots equal HostEraPipeline's (on the
    native host library, as the checks below), no host
    recompute, and a warm era's traced launches equal the counted ones.
    Then GpuTpkeVerifier on slot 0 (K=64), curve.g1_msm / g2_msm at n=100
    with 256 bits against the host MSM, and msm.tpke_era_glv_kernel's (S, 4)
    output against era_kernel's. Timed: the key tables' first call, and
    GLV_ROUNDS warm GLV eras and Pallas-path eras (`backend`) in turns:
    medians and quartiles of the wall and the device phase (CUDA events),
    the traced device time by kernel, the idle share."""
    import torch

    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto import tpke
    from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob, GpuBackend
    from lachain_tpu_torch.crypto.native_backend import NativeBackend
    from lachain_tpu_torch.ops import curve, g1, g2, glv, msm
    from lachain_tpu_torch.ops.verify import (
        GlvEraPipeline, GpuEraPipeline, GpuTpkeVerifier, HostEraPipeline)

    dealer, cts, msgs, jobs = era
    n = len(jobs)
    vks = dealer.verification_keys
    y_points = [vk.y_i for vk in vks]
    slots = [(list(j.u_by_validator), list(j.lagrange_row)) for j in jobs]
    names = tuple(GLV_LAUNCHES)

    def check_all(res, bad=()):
        for s, (ok, comb) in enumerate(res):
            if s in bad:
                check(ok is False and comb is None, f"glv era: slot {s} not isolated")
            else:
                check(ok and tpke.decrypt_with_combined(cts[s], comb) == msgs[s],
                      f"glv era: slot {s} not verified and decrypted")

    # the counted run: a fresh backend's first era, then a warm one
    glv_backend = GpuBackend(device=dev, pipeline=GlvEraPipeline(device=dev))
    reset_counts()
    t0 = time.perf_counter()
    res = glv_backend.tpke_era_verify_combine(jobs, vks, SeededRng(seed + 50))
    first_s = time.perf_counter() - t0
    first = {k: read_launches()[k] for k in names}
    check_all(res)
    check(first == GLV_FIRST, f"glv era: first era launches {first} != {GLV_FIRST}")
    res = glv_backend.tpke_era_verify_combine(jobs, vks, SeededRng(seed + 51))
    launches = read_launches()
    check_no_escapes("glv era")
    check_all(res)
    warm_got = {k: launches[k] - first[k] for k in names}
    check(warm_got == GLV_LAUNCHES, f"glv era: warm launches {warm_got} != {GLV_LAUNCHES}")
    log(f"glv era N={n}: {n} slots verified and decrypted through "
        f"GpuBackend(pipeline=GlvEraPipeline()); first era {first_s:.3f} s, launches "
        f"{first}; warm era launches {warm_got}; phases {glv_backend.last_timings}")

    bad_slot = n // 4 + 1
    row = list(jobs[bad_slot].u_by_validator)
    row[3] = bls.g1_add(row[3], bls.G1_GEN)
    poisoned = list(jobs)
    poisoned[bad_slot] = EraSlotJob(row, jobs[bad_slot].lagrange_row,
                                    jobs[bad_slot].h, jobs[bad_slot].w)
    check_all(glv_backend.tpke_era_verify_combine(poisoned, vks, SeededRng(seed + 52)),
              bad=(bad_slot,))
    log(f"glv era, poisoned: slot {bad_slot} isolated, the others decrypt")

    # a warm era's traced launches against the counted ones
    warm_pipe = GlvEraPipeline(device=dev)
    warm_pipe.run_era(slots, y_points, SeededRng(seed + 53))
    by_kernel = profile_launches(
        lambda: warm_pipe.run_era(slots, y_points, SeededRng(seed + 54)),
        {KERNEL_OF[k]: GLV_LAUNCHES[k] for k in names}, "glv era")
    check_traced("glv era (warm)", by_kernel, warm_got, names)

    # the host oracles on the native library: independent of the kernels,
    # and seconds faster than pure Python at these sizes
    host = NativeBackend()
    got, got_rlc = warm_pipe.run_era(slots[:4], y_points, SeededRng(seed + 55))
    want, want_rlc = HostEraPipeline(host).run_era(slots[:4], y_points,
                                                   SeededRng(seed + 55))
    check(got_rlc == want_rlc, "glv era: rlc draws differ")
    for s, (a, b) in enumerate(zip(got, want)):
        check(all(bls.g1_eq(x, y) for x, y in zip(a, b)),
              f"glv era: slot {s} differs from HostEraPipeline")
    log("glv era: 4 slots equal to HostEraPipeline (u_agg, y_agg, combined, rlc)")

    # GpuTpkeVerifier on slot 0, all 64 shares
    rng = random.Random(seed + 56)
    u0, lag0 = slots[0]
    rlc0 = [rng.randrange(1, 1 << 64) for _ in range(n)]
    reset_counts()
    t0 = time.perf_counter()
    ok, comb = GpuTpkeVerifier(device=dev).verify_and_combine(
        u0, y_points, jobs[0].h, jobs[0].w, rlc0, lag0)
    ver_s = time.perf_counter() - t0
    check_no_escapes("GpuTpkeVerifier")
    check(ok and tpke.decrypt_with_combined(cts[0], comb) == msgs[0],
          "GpuTpkeVerifier: slot 0 not verified and decrypted")
    check(bls.g1_eq(comb, host.g1_msm(u0, lag0)), "GpuTpkeVerifier: combined != host")
    log(f"GpuTpkeVerifier, slot 0 (K={n}): ok, combined equals the host MSM, "
        f"{ver_s:.3f} s, launches {read_launches()}")

    # the bit-serial MSM entries at n = 100 with 256 bits
    g1_pts = glv.point_run(rng, 100)
    g1_pts[7] = bls.G1_INF
    g2_pts = glv.point_run(rng, 100, mul=bls.g2_mul, add=bls.g2_add, gen=bls.G2_GEN)
    scalars = [rng.randrange(bls.R) for _ in range(100)]
    bits = torch.from_numpy(curve.scalars_to_bits(scalars, 256)).to(dev)
    reset_counts()
    out = []
    for pack, fn in ((g1.g1_pack, curve.g1_msm), (g2.g2_pack, curve.g2_msm)):
        pt, fl = fn(pack(g1_pts if fn is curve.g1_msm else g2_pts, dev), bits)
        out.append(g1.fetch(torch.cat([pt, fl.to(pt.dtype)[None]])[:, None]))
    msm_launches = read_launches()
    cpu = dev.type == "cpu"
    got1 = g1.g1_unpack_host(*out[0], cpu)[0]
    got2 = g2.g2_unpack_host(*out[1], cpu)[0]
    check(bls.g1_eq(got1, host.g1_msm(g1_pts, scalars)), "curve.g1_msm != host")
    check(bls.g2_eq(got2, host.g2_msm(g2_pts, scalars)), "curve.g2_msm != host")
    log(f"curve.g1_msm and g2_msm at n=100 (256 bits, an infinity input) equal "
        f"the host MSM; launches {msm_launches}")

    # the 4K-lane era kernel's (S, 4) entry against era_kernel
    k_pad = n
    u = g1.g1_pack([p for u_list, _ in slots for p in u_list], dev)
    y = g1.g1_pack(y_points * n, dev)
    rlc16, lag1, lag2 = (torch.from_numpy(d).to(dev) for d in msm.era_digits(
        [rng.randrange(1, 1 << 64) for _ in range(n * n)],
        [c for _, lag in slots for c in lag]))
    pts, flags = msm.tpke_era_glv_kernel(u, y, rlc16, lag1, lag2, k_pad)
    out_r, ofl_r, out_l, ofl_l = g1.era_kernel(u, y, rlc16, lag1, lag2, k_pad)
    check(torch.equal(pts, torch.cat([out_r, out_l], 1).reshape(-1, 4, n).transpose(1, 2))
          and torch.equal(flags, torch.cat([ofl_r, ofl_l]).reshape(4, n).T),
          "tpke_era_glv_kernel (S, 4) != era_kernel")
    log(f"msm.tpke_era_glv_kernel: (S, 4) = {tuple(flags.shape)} output equal to "
        f"era_kernel's, word for word")

    # times: the key tables' first call, then warm eras in turns
    fresh = GlvEraPipeline(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables = fresh.y_device(y_points)
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    kk = g1.g1_pack(y_points, dev)
    tables_ms = cuda_ms(lambda: msm.y_fixed_base_tables(kk), 5)
    log(f"glv key tables ({tuple(tables.shape)}, {tables.numel() * 4 / 1e6:.2f} MB): "
        f"first call {tables_s * 1e3:.3f} ms on the host clock (pack, g1_mont, "
        f"g1_fixed_tables, synchronized); g1_fixed_tables alone {tables_ms:.4f} ms")
    paths = {"glv": glv_backend, "pallas": backend}
    walls = {p: [] for p in paths}
    device = {p: [] for p in paths}
    warm = []
    for r in range(GLV_ROUNDS):
        for p in (("glv", "pallas") if r % 2 == 0 else ("pallas", "glv")):
            b = paths[p]
            t0 = time.perf_counter()
            check_all(b.tpke_era_verify_combine(jobs, vks, SeededRng(seed + 60 + r)))
            wall = time.perf_counter() - t0
            walls[p].append(wall)
            device[p].append(b.last_timings["device_s"])
            if p == "glv":
                warm.append(dict(b.last_timings, wall_s=wall))
    pal_pipe = GpuEraPipeline(device=dev)
    pal_pipe.run_era(slots, y_points, SeededRng(seed + 57))
    for p, pipe in (("glv", warm_pipe), ("pallas", pal_pipe)):
        by_kernel = profile_device(lambda: pipe.run_era(slots, y_points, SeededRng(seed + 58)))
        busy = sum(v[0] for v in by_kernel.values())
        wq, dq = quartiles(walls[p]), quartiles(device[p])
        log(f"{p} era warm: wall median {wq[1] * 1e3:.3f} ms (q1 {wq[0] * 1e3:.3f}, "
            f"q3 {wq[2] * 1e3:.3f}), device phase median {dq[1] * 1e3:.3f} ms (q1 "
            f"{dq[0] * 1e3:.3f}, q3 {dq[2] * 1e3:.3f}) over {GLV_ROUNDS} eras in turns; "
            f"traced device {busy:.3f} ms by kernel (ms, launches) {by_kernel}; idle "
            f"share {1 - busy / (wq[1] * 1e3):.4f}")
    return launches, warm


# ---------------------------------------------------------------------------
# phase 3: the N=64 era on a virtual mesh of the card (parallel/mesh.py)
# ---------------------------------------------------------------------------


def median_line(xs) -> str:
    """"median (q1, q3)" of seconds, in ms."""
    q1, med, q3 = quartiles(xs)
    return f"{med * 1e3:.3f} ({q1 * 1e3:.3f}, {q3 * 1e3:.3f})"


def run_mesh_path(seed: int, backend, dev, era, devices, msm_devices=None):
    """The N=64 era through GpuBackend(pipeline=MeshEraPipeline(devices=
    devices)) (n copies of cuda:0, or distinct cards): a fresh backend's
    first era is counted (mesh_launches) and every slot's (ok, combined)
    must equal the tpke_era path's one-card backend on the same rng, with
    no host recompute; then MESH_ROUNDS warm eras in turns with that
    backend (launch, device (events) and wall medians, the mesh's
    gather_mb), and a warm era's traced device time by kernel, whose
    launches must be the counted ones less the key packs, with the idle
    share. With `msm_devices`, sharded_g1_msm / sharded_g2_msm at n=100
    over a 1-D mesh of them against GpuBackend.g1_msm / g2_msm."""
    import torch

    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto import tpke
    from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
    from lachain_tpu_torch.ops import curve, g1, g2, glv
    from lachain_tpu_torch.parallel.mesh import (
        MeshEraPipeline, make_mesh, sharded_g1_msm, sharded_g2_msm)

    dealer, cts, msgs, jobs = era
    vks = dealer.verification_keys
    mesh_backend = GpuBackend(device=devices[0], pipeline=MeshEraPipeline(devices=devices))
    pipe = mesh_backend._pipeline
    n_slot, n_share = pipe.mesh.devices.shape
    cards = len(pipe.mesh.distinct())
    label = f"mesh era {n_slot}x{n_share}" + (f" over {cards} cards" if cards > 1 else "")

    want = backend.tpke_era_verify_combine(jobs, vks, SeededRng(seed + 70))
    reset_counts()
    t0 = time.perf_counter()
    res = mesh_backend.tpke_era_verify_combine(jobs, vks, SeededRng(seed + 70))
    first_s = time.perf_counter() - t0
    launches = read_launches()
    check_no_escapes(label)
    expect = mesh_launches(pipe.mesh.devices)
    key_packs = expect["g1_mont"] - 2 * pipe.n_devices - 1
    got = {k: launches[k] for k in expect}
    check(got == expect, f"{label}: launches {got} != {expect}")
    for s, ((ok, comb), (ok1, comb1)) in enumerate(zip(res, want)):
        check(ok is ok1 is True and bls.g1_eq(comb, comb1)
              and tpke.decrypt_with_combined(cts[s], comb) == msgs[s],
              f"{label}: slot {s} differs from the tpke_era path")
    log(f"{label}: {len(jobs)} slots equal the tpke_era path's (ok, combined) and "
        f"decrypt; first era {first_s:.3f} s, launches "
        f"{ {k: v for k, v in launches.items() if v} }; pad waste {pipe.pad_waste}")

    walls = {"mesh": [], "tpke": []}
    phases = {p: {"launch_s": [], "device_s": []} for p in walls}
    warm, gather0 = [], pipe.gather_mb
    for r in range(MESH_ROUNDS):
        for p in (("mesh", "tpke") if r % 2 == 0 else ("tpke", "mesh")):
            b = mesh_backend if p == "mesh" else backend
            t0 = time.perf_counter()
            res = b.tpke_era_verify_combine(jobs, vks, SeededRng(seed + 71 + r))
            wall = time.perf_counter() - t0
            check(all(ok for ok, _ in res), f"{label}: warm era {r} ({p}) failed")
            walls[p].append(wall)
            for key in phases[p]:
                phases[p][key].append(b.last_timings[key])
            if p == "mesh":
                warm.append(dict(b.last_timings, wall_s=wall))
    check_no_escapes(label)
    gather = (pipe.gather_mb - gather0) / MESH_ROUNDS
    for p in ("mesh", "tpke"):
        name = label if p == "mesh" else "tpke_era (same turns)"
        log(f"{name} warm over {MESH_ROUNDS} eras in turns, median (q1, q3) ms: "
            f"launch {median_line(phases[p]['launch_s'])}, device (events) "
            f"{median_line(phases[p]['device_s'])}, wall {median_line(walls[p])}"
            + (f"; gather_mb {gather:.6f} an era" if p == "mesh" else ""))

    # a warm era's device time by kernel; its traced launches are the
    # counted ones less the key packs
    slots = [(list(j.u_by_validator), list(j.lagrange_row)) for j in jobs]
    y_points = [vk.y_i for vk in vks]
    pipe.run_era(slots, y_points, SeededRng(seed + 73))
    names = tuple(k for k in expect if expect[k])
    want_traced = dict(expect, g1_mont=expect["g1_mont"] - key_packs)
    by_kernel = profile_launches(
        lambda: pipe.run_era(slots, y_points, SeededRng(seed + 74)),
        {KERNEL_OF[k]: want_traced[k] for k in names}, label)
    busy = sum(v[0] for v in by_kernel.values())
    log(f"{label} warm era by kernel (torch.profiler, ms, launches): {by_kernel}; "
        f"busy {busy:.3f} ms, idle share {1 - busy / quartiles(walls['mesh'])[1] / 1e3:.4f}")

    if msm_devices is not None:
        rng = random.Random(seed + 72)
        g1_pts = glv.point_run(rng, 100)
        g1_pts[7] = bls.G1_INF
        g2_pts = glv.point_run(rng, 100, mul=bls.g2_mul, add=bls.g2_add, gen=bls.G2_GEN)
        scalars = [rng.randrange(bls.R) for _ in range(100)]
        bits = torch.from_numpy(curve.scalars_to_bits(scalars, 256)).to(dev)
        msm_mesh = make_mesh(msm_devices)
        shards = len(msm_devices)
        for name, pts, pack, sharded, unpack, eq, msm in (
                ("g1", g1_pts, g1.g1_pack, sharded_g1_msm, g1.g1_unpack_host,
                 bls.g1_eq, backend.g1_msm),
                ("g2", g2_pts, g2.g2_pack, sharded_g2_msm, g2.g2_unpack_host,
                 bls.g2_eq, backend.g2_msm)):
            pt, fl = sharded(msm_mesh)(pack(pts, dev), bits)
            rows, flags = g1.fetch(torch.cat([pt, fl.to(pt.dtype)[None]])[:, None])
            check(eq(unpack(rows, flags, dev.type == "cpu")[0], msm(pts, scalars)),
                  f"sharded_{name}_msm over {shards} shards != GpuBackend.{name}_msm")
        check_no_escapes("sharded MSMs")
        log(f"sharded_g1_msm / sharded_g2_msm at n=100 (256 bits, an infinity "
            f"input) over {shards} shards on {len(msm_mesh.distinct())} card(s) "
            f"equal GpuBackend.g1_msm / g2_msm")
    return launches, warm


# ---------------------------------------------------------------------------
# phase 3: the N=64 coin era through threshold_sig.era_verify_combine
# ---------------------------------------------------------------------------


def make_coins(n: int, seed: int):
    """Trusted TS dealer and n coins, each holding the shares of the t+1
    lowest-id signers (the ones the combine reads) plus two more, signed on
    the native host library as a validator signs them."""
    from lachain_tpu_torch.crypto import threshold_sig
    from lachain_tpu_torch.crypto.native_backend import NativeBackend

    f = (n - 1) // 3
    dealer = threshold_sig.TsTrustedKeyGen(n, f, SeededRng(seed))
    host = NativeBackend()
    privs = [dealer.private_key_share(i) for i in range(f + 3)]
    coins = []
    for c in range(n):
        msg = b"coin|era=%d|id=%d" % (seed, c)
        coins.append((msg, {p.my_id: p.sign(msg, host) for p in privs}))
    return dealer.pub_key_set, coins


def run_coin_path(seed: int, backend, dev):
    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto import threshold_sig
    from lachain_tpu_torch.crypto.host import HostBackend
    from lachain_tpu_torch.ops.verify import TsGpuEraPipeline, TsHostEraPipeline

    n = N_VALIDATORS
    host = HostBackend()
    t0 = time.perf_counter()
    key_set, coins = make_coins(n, seed + 100)
    chosen = list(range(key_set.t + 1))
    log(f"coin host setup (dealer, {n} coins x {key_set.t + 3} signatures): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    want = [key_set.combine([shares[i] for i in chosen], host) for _, shares in coins]
    log(f"host combine of {n} coins: {time.perf_counter() - t0:.1f} s")

    def check_all(res, bad=()):
        for c, sig in enumerate(res):
            if c in bad:
                check(sig is None, f"coin {c} not isolated")
                continue
            check(sig is not None, f"coin {c} failed verification")
            check(sig.to_bytes() == want[c].to_bytes(), f"coin {c} != host combine")
            check(sig.parity == want[c].parity, f"coin {c} parity differs")

    # the main-path run whose launches are counted
    reset_counts()
    t0 = time.perf_counter()
    res = threshold_sig.era_verify_combine(key_set, coins, SeededRng(seed + 11), backend)
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    check_no_escapes("coin era")
    check_all(res)
    got = {k: launches[k] for k in COIN_LAUNCHES}
    check(got == COIN_LAUNCHES, f"coin era launches {got} != {COIN_LAUNCHES}")
    t0 = time.perf_counter()
    for (msg, _), sig in zip(coins, res):
        check(key_set.shared.verify(msg, sig, host), "signature fails shared key")
    log(f"coin era N={n}: {n} coins combined, each verifies under the shared "
        f"key ({time.perf_counter() - t0:.1f} s) with the host's parity; cold "
        f"{cold_s:.3f} s; launches {launches}; phases {backend.last_timings}")

    warm = []
    for r in range(2):
        t0 = time.perf_counter()
        res = threshold_sig.era_verify_combine(
            key_set, coins, SeededRng(seed + 12 + r), backend)
        wall = time.perf_counter() - t0
        check_all(res)
        warm.append(dict(backend.last_timings, wall_s=wall))
        log(f"coin era warm {r}: wall {wall:.4f} s, pairing_s "
            f"{backend.last_timings['pairing_s']:.4f} s on the {backend.host_name} "
            f"host backend, phases {backend.last_timings}")

    # one poisoned chosen share must isolate exactly its coin
    bad_coin = n // 4 + 1
    poisoned = list(coins)
    msg, shares = coins[bad_coin]
    shares = dict(shares)
    shares[1] = threshold_sig.PartialSignature(bls.g2_add(shares[1].sigma, bls.G2_GEN), 1)
    poisoned[bad_coin] = (msg, shares)
    t0 = time.perf_counter()
    res = threshold_sig.era_verify_combine(key_set, poisoned, SeededRng(seed + 19), backend)
    check_all(res, bad=(bad_coin,))
    log(f"poisoned coin era: coin {bad_coin} isolated, others combine; "
        f"{time.perf_counter() - t0:.2f} s")

    # the coin rows era_verify_combine hands the pipeline
    lag = [0] * n
    for i, c in zip(chosen, bls.fr_lagrange_coeffs([i + 1 for i in chosen], at=0)):
        lag[i] = c
    rows = [([shares[i].sigma if i in chosen else bls.G2_INF for i in range(n)], lag)
            for _, shares in coins]
    masks = [[i in chosen for i in range(n)] for _ in coins]
    y_points = [k.y for k in key_set.keys]
    by_kernel = profile_phase("coin era", lambda: TsGpuEraPipeline(device=dev),
                              lambda p: p.run_era(rows, y_points, SeededRng(seed + 14),
                                                  masks=masks), launches, tuple(COIN_LAUNCHES))
    check_traced("coin era", by_kernel, launches, tuple(COIN_LAUNCHES))

    # 4 coins against the host oracle pipeline, same seeded rng
    dev_out, dev_rlc = TsGpuEraPipeline(device=dev).run_era(
        rows[:4], y_points, SeededRng(seed + 15), masks=masks[:4])
    host_out, host_rlc = TsHostEraPipeline().run_era(
        rows[:4], y_points, SeededRng(seed + 15), masks=masks[:4])
    check(dev_rlc == host_rlc, "coin rlc draws differ")
    for c, (a, b) in enumerate(zip(dev_out, host_out)):
        check(bls.g2_eq(a[0], b[0]) and bls.g1_eq(a[1], b[1])
              and bls.g2_eq(a[2], b[2]), f"coin {c} aggregate differs from host")
    log("4 coins equal to TsHostEraPipeline (sig_agg, y_agg, combined, rlc)")

    # the device MSM routes at n = 100 against the host MSM
    rng = random.Random(seed + 16)
    g2_pts = [s.sigma for _, shares in coins for s in shares.values()][:100]
    g1_pts = [key_set.keys[c % n].y for c in range(len(g2_pts))]
    scalars = [rng.randrange(bls.R) for _ in g2_pts]
    g1_pts[7] = bls.G1_INF
    reset_counts()
    t0 = time.perf_counter()
    got2, got1 = backend.g2_msm(g2_pts, scalars), backend.g1_msm(g1_pts, scalars)
    dev_s = time.perf_counter() - t0
    msm_launches = read_launches()
    check_no_escapes("device MSMs")
    idle = [k for k in ("g1_table", "g1_add", "g1_msm_scan", "g2_table", "g2_add",
                        "g2_msm_scan") if msm_launches[k] == 0]
    check(not idle, f"device MSMs never launched: {idle}")
    check(bls.g2_eq(got2, host.g2_msm(g2_pts, scalars)), "device g2_msm != host")
    check(bls.g1_eq(got1, host.g1_msm(g1_pts, scalars)), "device g1_msm != host")
    log(f"device g2_msm and g1_msm at n={len(g2_pts)} equal the host MSM, "
        f"no host recompute ({dev_s:.3f} s); launches {msm_launches}")
    return launches, warm


# ---------------------------------------------------------------------------
# phase 3: pool-ingest ECDSA recovery through ecdsa.recover_hash_batch
# ---------------------------------------------------------------------------

MALFORMED = ("flip_s", "r_zero", "r_above_n", "v_four", "non_residue",
             "z_zero", "short_sig", "short_hash")


def make_signatures(n: int, senders: int, rng: random.Random):
    """n signatures by `senders` seeded keys over random hashes, with the
    signer's own s, v and low-s rule (ecdsa._signature) and nonces that step
    by one: R_{i+1} = R_i + G, one affine add each instead of a scalar
    multiplication per signature. Every signature has its own R and z."""
    from lachain_tpu_torch.crypto import ecdsa

    privs = [rng.randrange(1, ecdsa.N).to_bytes(32, "big") for _ in range(senders)]
    pubs = [ecdsa.public_key_bytes(p) for p in privs]
    k = rng.randrange(1, ecdsa.N - n)
    rp = ecdsa._mul(ecdsa.G, k)
    hashes, sigs, owner = [], [], []
    for i in range(n):
        h = rng.randbytes(32)
        sig = ecdsa._signature(int.from_bytes(privs[i % senders], "big"),
                               int.from_bytes(h, "big") % ecdsa.N, k, rp)
        check(sig is not None, "r or s came out 0")
        hashes.append(h)
        sigs.append(sig)
        owner.append(i % senders)
        k += 1
        rp = ecdsa._add(rp, ecdsa.G)
    return pubs, hashes, sigs, owner


def malform(kind: str, h: bytes, sig: bytes, rng: random.Random):
    """One (hash, signature) of a malformed kind from a valid pair."""
    from lachain_tpu_torch.crypto import ecdsa

    if kind == "flip_s":  # still well-formed: recovers another key
        b = bytearray(sig)
        b[40] ^= 0xFF
        return h, bytes(b)
    if kind == "r_zero":
        return h, bytes(32) + sig[32:]
    if kind == "r_above_n":
        return h, (ecdsa.N + rng.randrange(1, 1 << 64)).to_bytes(32, "big") + sig[32:]
    if kind == "v_four":
        return h, sig[:64] + bytes([4])
    if kind == "non_residue":  # x^3 + 7 has no square root: the y^2 check
        r = rng.randrange(1, ecdsa.N)
        while pow((r**3 + 7) % ecdsa.P, (ecdsa.P - 1) // 2, ecdsa.P) != ecdsa.P - 1:
            r += 1
        return h, r.to_bytes(32, "big") + sig[32:]
    if kind == "z_zero":  # u2 = 0: the G lane's digits are all zero
        return bytes(32), sig
    if kind == "short_sig":
        return h, sig[:64]
    return h[:31], sig  # short_hash


def degenerate_signature():
    """u1*R == u2*G (tests/test_psecp.py:107-123): R = kG, s = (N-z)/k, so
    the recover kernel's pairwise add meets p == q and gives Z = 0."""
    from lachain_tpu_torch.crypto import ecdsa

    k, z = 0x1234567, 0x55AA
    rp = ecdsa._mul(ecdsa.G, k)
    s = (ecdsa.N - z) * pow(k, -1, ecdsa.N) % ecdsa.N
    return (z.to_bytes(32, "big"),
            rp[0].to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([rp[1] & 1]))


def recover_launches(n: int) -> dict:
    """The launches of one recover_hash_batch whose n signatures reach the
    scans: one square root, and per 4096-signature chunk 1 table build, 1
    scan, 1 pair add and 2 conversions."""
    from lachain_tpu_torch.ops.secp import GpuEcdsaRecover

    chunks = -(-n // GpuEcdsaRecover.CHUNK)
    want = dict.fromkeys(read_launches(), 0)
    want.update(secp_sqrt=1, secp_table=chunks, secp_add=chunks, secp_msm_scan=chunks,
                secp_mont=2 * chunks)
    return want


def run_ecdsa_path(seed: int, dev):
    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.ops import secp, verify
    from lachain_tpu_torch.ops.secp import GpuEcdsaRecover

    rng = random.Random(seed + 200)
    n = N_SIGNATURES
    t0 = time.perf_counter()
    pubs, hashes, sigs, owner = make_signatures(n, N_SENDERS, rng)
    bad = {}
    for j, i in enumerate(rng.sample(range(n), 4 * len(MALFORMED))):
        kind = MALFORMED[j % len(MALFORMED)]
        hashes[i], sigs[i] = malform(kind, hashes[i], sigs[i], rng)
        bad[i] = kind
    log(f"ecdsa host setup ({N_SENDERS} keys, {n} signatures, {len(bad)} "
        f"malformed): {time.perf_counter() - t0:.1f} s")

    # the launches one chunked call must make: one square root over the
    # x values that pass validation (plain words in and out, no
    # conversion launch around it); per chunk of 4096 signatures 1
    # conversion into Montgomery form (the pack), 1 table build, 1 scan, 1
    # pairwise add and 1 conversion out of it (the fetch). The signatures
    # that reach the scans: the valid ones, flip_s and z_zero.
    m = sum(GpuEcdsaRecover._validate(h, s) is not None for h, s in zip(hashes, sigs))
    check(m == RECOVER_SQRT_LANES,
          f"{m} x values reach the square root, not {RECOVER_SQRT_LANES}")
    n_jobs = sum(1 for i in range(n) if bad.get(i, "flip_s") in ("flip_s", "z_zero"))
    chunks = -(-n_jobs // GpuEcdsaRecover.CHUNK)
    want_launches = recover_launches(n_jobs)

    # the main-path run whose launches are counted
    reset_counts()
    t0 = time.perf_counter()
    got = ecdsa.recover_hash_batch(hashes, sigs, device="cuda")
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    check_no_escapes("ecdsa recover")
    check(chunks == 3, f"expected 3 chunks of the 10,000-signature batch, got {chunks}")
    check(launches == want_launches,
          f"ecdsa launches {launches} != expected {want_launches}")
    for i in range(n):
        if i not in bad:
            check(got[i] == pubs[owner[i]], f"signature {i} recovered the wrong key")
    t0 = time.perf_counter()
    for i, kind in bad.items():
        check(got[i] == ecdsa.recover_hash(hashes[i], sigs[i]),
              f"malformed {kind} at {i} differs from recover_hash")
    sample = rng.sample([i for i in range(n) if i not in bad], 64)
    for i in sample:
        check(got[i] == ecdsa.recover_hash(hashes[i], sigs[i]),
              f"signature {i} differs from recover_hash")
    kinds = {k: sum(1 for v in bad.values() if v == k) for k in MALFORMED}
    log(f"ecdsa recover of {n}: every valid signature gave its sender's key, "
        f"{len(bad)} malformed ({kinds}) and 64 valid equal recover_hash "
        f"({time.perf_counter() - t0:.1f} s); {n_jobs} on the card in {chunks} "
        f"chunks; cold {cold_s:.3f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }")

    # the crafted collision, in a call of its own: one answer from the oracle
    dh, ds = degenerate_signature()
    reset_counts()
    one = ecdsa.recover_hash_batch([dh], [ds], device="cuda")
    check(verify.ESCAPES == dict(dict.fromkeys(verify.ESCAPES, 0), ecdsa_recover=1),
          f"collision: escapes {verify.ESCAPES}")
    check(one == [ecdsa.recover_hash(dh, ds)] and one[0] is not None,
          "collision answer differs from recover_hash")
    log(f"crafted u1*R == u2*G signature: answered by the host oracle once "
        f"(ESCAPES {verify.ESCAPES}), equal to recover_hash")

    # warm runs of the card path on the regular entries (what
    # recover_hash_batch hands GpuEcdsaRecover), with their phase split
    regular = [i for i in range(n) if len(hashes[i]) == 32 and len(sigs[i]) == 65]
    rh, rs = [hashes[i] for i in regular], [sigs[i] for i in regular]
    rec = GpuEcdsaRecover(dev)
    warm = []
    for r in range(2):
        out = rec.recover_batch(rh, rs)
        check(out == [got[i] for i in regular], "warm recover differs")
        warm.append(dict(rec.last_timings))
        log(f"ecdsa warm {r}: {rec.last_timings}")
    by_kernel = profile_launches(lambda: rec.recover_batch(rh, rs),
                                 {KERNEL_OF[k]: launches[k] for k in SECP_KERNELS},
                                 "ecdsa recover")
    busy = sum(v[0] for v in by_kernel.values())
    t = rec.last_timings
    log(f"ecdsa recover by kernel (torch.profiler, ms, launches): {by_kernel}; "
        f"busy {busy:.3f} ms of sqrt {t['sqrt_s'] * 1e3:.3f} ms + device "
        f"{t['device_s'] * 1e3:.3f} ms (profiled wall {t['wall_s']:.3f} s)")
    # the regular entries reach the card as the main-path call's did
    check_traced("ecdsa recover", by_kernel, launches, SECP_KERNELS)
    return launches, warm


# ---------------------------------------------------------------------------
# the Reed-Solomon product and the RBC flush
# ---------------------------------------------------------------------------


def rs_entry(dev, bits: int, mats, b, widths, layout: str, reps: int) -> dict:
    """One rs_matmul launch over numpy groups `mats` (put into the
    kernel's form on the host, as the flush's cache does) and columns `b`
    against its plain version on the card, bit for bit; both timed (the
    wrapper's calls by CUDA events, which include its host time, and the
    kernel's own device time from torch.profiler, `traced_ms`); the bound
    the larger of B in and C out over HBM's rate and the terms these inputs
    need (both factors nonzero) over one term a lane a clock; GF(2^8) also
    its nibble design's integer operations (7 a word of 4 products a row,
    12 a word's selectors a row block) over 64 INT32 lanes an SM."""
    import numpy as np
    import torch

    from lachain_tpu_torch.ops import _build, rs_batch

    field = rs_batch.GF8 if bits == 8 else rs_batch.gf16()
    kmats = [torch.from_numpy(rs_batch.operand(bits, m)).to(dev) for m in mats]
    kb = torch.from_numpy(b).to(dev)
    got = rs_batch.rs_matmul(bits, kmats, kb, widths).cpu().numpy().astype(np.int64)
    want, plain_ms = cuda_ms_once(lambda: rs_batch.rs_matmul_plain(bits, kmats, kb, widths))
    want = want.cpu().numpy().astype(np.int64)
    lookups, int_ops, off = 0, 0, 0
    rows_a_thread = rs_batch.geometry(_build.library(), bits)[0]
    for m, w in zip(mats, widths):
        nz_b = (b[: m.shape[1], off : off + w] != 0).sum(axis=1)
        lookups += int(((m != 0).sum(axis=0) * nz_b).sum())
        words = (off + w + 3) // 4 - off // 4 if w else 0
        int_ops += m.shape[1] * words * (7 * m.shape[0] + 12 * -(-m.shape[0] // rows_a_thread))
        off += w
    name = f"rs_matmul{bits}_kernel"
    traced = profile_launches(
        lambda: [rs_batch.rs_matmul(bits, kmats, kb, widths) for _ in range(10)],
        {name: 10}, layout)[name]
    nbytes = (b.size + got.size) * field.sym_size
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = lookups / LOOKUPS_PER_S * 1e3
    entry = dict(
        layout=layout, lanes=int(b.shape[1]), groups=len(mats), lookups=lookups,
        ok=bool((got == want).all()), max_abs_err=float(np.abs(got - want).max()),
        ms=cuda_ms(lambda: rs_batch.rs_matmul(bits, kmats, kb, widths), reps),
        traced_ms=traced[0] / traced[1], plain_ms=plain_ms,
        bound=(t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"),
    )
    if bits == 8:
        entry.update(int_ops=int_ops, int_bound_ms=int_ops / INT32_OPS_PER_S * 1e3)
    return entry


def check_rs_kernels(rng: random.Random, dev):
    """rs_matmul8 and rs_matmul16 at every launch shape of the RBC flushes,
    the A matrices the codec's own (Vandermonde, Gauss-Jordan inverses), B
    random symbols. GF(2^8): the N=64 re-encode (the entry's numbers), the
    own proposal's encode and the grouped decode of 64 distinct inverses
    at the flush's layout (131 columns a group, words shared by two
    groups), the 10,000-tx block's re-encode, and a ragged check of
    widths 1, 7, 123 with zero rows and columns in A and B.
    GF(2^16): the N=256 re-encode (its numbers), the own proposal's encode,
    the decode of 256 distinct inverses, and a ragged check."""
    import numpy as np

    from lachain_tpu_torch.ops import rs_batch

    nprng = np.random.default_rng(rng.randrange(1 << 32))
    gf8, gf16 = rs_batch.GF8, rs_batch.gf16()

    def symbols(field, rows, cols):
        return nprng.integers(0, field.order + 1, (rows, cols)).astype(field.dtype)

    def inverses(field, n, k, count):
        patterns = set()
        while len(patterns) < count:
            patterns.add(tuple(sorted(rng.sample(range(1, n + 1), k))))
        return [rs_batch._inverse_for(field, k, xs) for xs in sorted(patterns)]

    def zero_lines(mats, b):
        mats = [m.copy() for m in mats]
        for m in mats:
            m[nprng.integers(m.shape[0])] = 0
            m[:, nprng.integers(m.shape[1])] = 0
        b = b.copy()
        b[:, ::3] = 0
        return mats, b

    v64 = rs_batch.vandermonde(gf8, 22, 64)
    inv64 = inverses(gf8, 64, 22, 64)
    ragged8 = zero_lines([v64[:9, :5], v64[:3, :5], v64[:64, :22]], symbols(gf8, 22, 1 + 7 + 123))
    checks8 = [
        rs_entry(dev, 8, [v64], symbols(gf8, 22, 8384), [8384],
                 "N=64 re-encode (64 x 22)(22 x 8384)", 100),
        rs_entry(dev, 8, [v64], symbols(gf8, 22, 131), [131],
                 "N=64 encode (64 x 22)(22 x 131)", 100),
        rs_entry(dev, 8, inv64, symbols(gf8, 22, 64 * 131), [131] * 64,
                 "N=64 decode, 64 groups (22 x 22)(22 x 131)", 100),
        rs_entry(dev, 8, [v64], symbols(gf8, 22, 82624), [82624],
                 "10,000-tx block re-encode (64 x 22)(22 x 82624)", 20),
        rs_entry(dev, 8, *ragged8, [1, 7, 123],
                 "ragged: widths 1, 7, 123, zero rows and columns", 20),
    ]
    v256 = rs_batch.vandermonde(gf16, 86, 256)
    inv256 = inverses(gf16, 256, 86, 256)
    checks16 = [
        rs_entry(dev, 16, [v256], symbols(gf16, 86, 1280), [1280],
                 "N=256 re-encode (256 x 86)(86 x 1280)", 100),
        rs_entry(dev, 16, [v256], symbols(gf16, 86, 5), [5],
                 "N=256 encode (256 x 86)(86 x 5)", 100),
        rs_entry(dev, 16, inv256, symbols(gf16, 86, 256 * 5), [5] * 256,
                 "N=256 decode, 256 groups (86 x 86)(86 x 5)", 50),
        rs_entry(dev, 16, *zero_lines([v256[:130, :86], inv256[0][:3, :86]],
                                      symbols(gf16, 86, 301 + 2)), [301, 2],
                 "ragged: widths 301, 2, zero rows and columns", 20),
    ]
    for c in checks8[1:] + checks16[1:]:
        report_line("rs_matmul check", c)
    for bits, checks in ((8, checks8), (16, checks16)):
        for c in checks:
            extra = (f", integer-op bound {c['int_bound_ms']:.5f} ms" if "int_bound_ms" in c
                     else "")
            log(f"rs_matmul{bits} ({c['layout']}): device time {c['traced_ms']:.4f} ms a "
                f"launch (torch.profiler), {c['lookups']} terms{extra}")
    return {
        f"rs_matmul{bits}": dict(checks[0], checks=checks[1:], ok=all(c["ok"] for c in checks))
        for bits, checks in ((8, checks8), (16, checks16))
    }


def proposal_bytes(transfers: int) -> int:
    """A proposal's TPKE ciphertext: U (48 B), W (96 B), two u32 fields,
    V's length prefix and V, the transfers each a 177-byte signed transfer
    (lachain_tpu/core/types.py:80) behind a 4-byte length."""
    return 48 + 96 + 2 * 4 + 4 + transfers * (4 + 177)


def make_rbc_era(n: int, rng: random.Random):
    """One validator's RBC work of an era at N=n: (k, own proposal, the
    slots' payloads, [(shards with erasures, root)]). Every slot has its
    own seeded payload and root and loses a seeded 0..n-k shards; slot n-2
    is equivocating (some of its first k shards from another polynomial,
    all under one root), slot n-1 has a first shard of another size."""
    from lachain_tpu_torch.crypto import hashes
    from lachain_tpu_torch.ops import rs_batch

    k = n - 2 * ((n - 1) // 3)
    size = proposal_bytes(BLOCK_TXS // n)
    own = rng.randbytes(size)
    payloads = [rng.randbytes(size) for _ in range(n)]
    coded = rs_batch.encode_batch([(p, k, n) for p in payloads + [own]], device="numpy")
    evil = coded[-1]
    slots = []
    for s, shards in enumerate(coded[:n]):
        shards = list(shards)
        if s == n - 2:
            for i in rng.sample(range(k), 3):
                shards[i] = evil[rng.randrange(n)]
        elif s == n - 1:
            shards[0] = shards[0] + bytes(rs_batch.field_for(n).sym_size)
        slots.append(shards)
    roots = hashes.merkle_roots([hashes.keccak256_batch(sh) for sh in slots])
    era = []
    for s, (shards, root) in enumerate(zip(slots, roots)):
        if s < n - 2:
            for i in rng.sample(range(n), rng.randint(0, n - k)):
                shards[i] = None
        era.append((shards, root))
    return k, own, payloads, era


def rbc_flush(device, n: int, k: int, own: bytes, era, mesh=None):
    """A fresh RbcEraBatcher on `device` (or `mesh`) takes the era's own
    encode and one interpolation per slot and flushes -> (batcher, encoded
    shards, verdicts). With no mesh, a flush on the card runs on that one
    card, where more cards would give the batcher a mesh over them."""
    from lachain_tpu_torch.consensus.rbc_batcher import RbcEraBatcher
    from lachain_tpu_torch.parallel.mesh import make_mesh

    if mesh is None and device not in ("cpu", "numpy"):
        mesh = make_mesh([device])

    batcher = RbcEraBatcher(device=device, mesh=mesh)
    enc, verdicts = [], [None] * len(era)
    batcher.submit_encode(0, own, k, n, enc.append)
    for s, (shards, root) in enumerate(era):
        batcher.submit_interpolate(0, shards, k, n, root,
                                   lambda v, s=s: verdicts.__setitem__(s, v))
    batcher.flush()
    return batcher, enc[0], verdicts


def run_rbc_path(seed: int, n: int, dev):
    """The RBC flush of one validator's era at N=n on the card: the
    counted cold flush, the host oracle, warm flushes, the profiler split,
    and the same flush's wall with the plain versions and the numpy
    oracle."""
    from lachain_tpu_torch.consensus.rbc_batcher import scalar_verdict
    from lachain_tpu_torch.ops import rs, rs_batch

    label = f"rbc flush N={n}"
    rng = random.Random(seed + 300 + n)
    t0 = time.perf_counter()
    k, own, payloads, era = make_rbc_era(n, rng)
    field = rs_batch.field_for(n)
    log(f"{label}: host setup ({n} slots, k={k}, GF(2^{field.bits}), proposals of "
        f"{len(own)} B): {time.perf_counter() - t0:.1f} s")
    rbc_flush(dev, n, k, own, era[:1])  # the field's tables onto the card

    # the main-path run whose launches are counted: a cold flush, every
    # erasure pattern's inverse made anew on the host
    rs_batch.clear_caches()
    reset_counts()
    batcher, enc, verdicts = rbc_flush("cuda", n, k, own, era)
    launches = read_launches()
    check_no_escapes(label)
    want_launches = dict(dict.fromkeys(launches, 0), **{f"rs_matmul{field.bits}": RBC_LAUNCHES})
    check(launches == want_launches, f"{label}: launches {launches} != {want_launches}")
    log(f"{label} cold: {phase_line(batcher.last_timings)}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")

    t0 = time.perf_counter()
    for s, (shards, root) in enumerate(era):
        check(verdicts[s] == scalar_verdict(shards, k, root),
              f"{label}: slot {s} differs from scalar_verdict")
        check((verdicts[s] is None) == (s >= n - 2),
              f"{label}: slot {s} verdict {'None' if verdicts[s] is None else 'a payload'}")
        if s < n - 2:
            check(verdicts[s] == payloads[s], f"{label}: slot {s} payload differs")
    want_enc = (rs.encode(own, k, n) if n <= 255
                else rs_batch.encode(own, k, n, device="numpy"))
    check(enc == want_enc, f"{label}: the encode differs from the host codec")
    log(f"{label}: {n} verdicts equal scalar_verdict (None on the equivocating "
        f"and the mixed-size slot), the encode the host codec's "
        f"({time.perf_counter() - t0:.1f} s)")

    warm = []
    for r in range(2):
        b, e, v = rbc_flush("cuda", n, k, own, era)
        check(e == enc and v == verdicts, f"{label}: warm flush {r} differs")
        warm.append(dict(b.last_timings))
    best = {p: min(w[p] for w in warm) for p in warm[0]}
    log(f"{label} warm (each phase the best of 2): {phase_line(best)}")
    by_kernel = profile_launches(lambda: rbc_flush("cuda", n, k, own, era),
                                 {KERNEL_OF[k]: launches[k] for k in RS_KERNELS}, label)
    busy = sum(v[0] for v in by_kernel.values())
    log(f"{label} by kernel (torch.profiler, ms, launches): {by_kernel}; busy {busy:.3f} ms")
    check_traced(label, by_kernel, launches, RS_KERNELS)
    for device in ("cpu", "numpy"):
        b, e, v = rbc_flush(device, n, k, own, era)
        check(e == enc and v == verdicts, f"{label}: the {device} flush differs")
        log(f"{label} with device={device!r} (reference, no yardstick): "
            f"{phase_line(b.last_timings)}")
    return launches, [dict(w) for w in warm]


def run_rbc_mesh_path(seed: int, dev, devices):
    """The RBC flushes of run_rbc_path (the same seeded eras) through
    RbcEraBatcher(mesh=make_mesh(devices)) (RBC_MESH copies of cuda:0, or
    distinct cards): every group's columns in a block a device, one
    rs_matmul launch a block of each of the flush's three products. Every
    verdict and the encode must equal the one-card flush's and
    scalar_verdict's; launches a flush counted; warm walls beside the
    one-card flush's."""
    from lachain_tpu_torch.consensus.rbc_batcher import scalar_verdict
    from lachain_tpu_torch.ops import rs_batch
    from lachain_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices)
    n_shards, cards = len(devices), len(mesh.distinct())
    total = dict.fromkeys(read_launches(), 0)
    warm = []
    for n in RBC_ERAS:
        label = f"rbc flush mesh N={n}" + (f" over {cards} cards" if cards > 1 else "")
        k, own, payloads, era = make_rbc_era(n, random.Random(seed + 300 + n))
        bits = rs_batch.field_for(n).bits
        _, enc1, verdicts1 = rbc_flush(dev, n, k, own, era)  # the inverses cached
        reset_counts()
        batcher, enc, verdicts = rbc_flush(dev, n, k, own, era, mesh=mesh)
        launches = read_launches()
        check_no_escapes(label)
        want = dict(dict.fromkeys(launches, 0), **{f"rs_matmul{bits}": RBC_LAUNCHES * n_shards})
        check(launches == want, f"{label}: launches {launches} != {want}")
        check(enc == enc1 and verdicts == verdicts1,
              f"{label}: differs from the one-card flush")
        for s, (shards, root) in enumerate(era):
            check(verdicts[s] == scalar_verdict(shards, k, root),
                  f"{label}: slot {s} differs from scalar_verdict")
        for key, v in launches.items():
            total[key] += v
        log(f"{label}: {n} verdicts and the encode equal the one-card flush's and "
            f"scalar_verdict's; {launches[f'rs_matmul{bits}']} rs_matmul{bits} launches "
            f"a flush over {n_shards} shards; {phase_line(batcher.last_timings)}")
        walls = {"mesh": [], "card": []}
        for r in range(4):
            for p in (("mesh", "card") if r % 2 == 0 else ("card", "mesh")):
                t0 = time.perf_counter()
                b, e, v = rbc_flush(dev, n, k, own, era, mesh=mesh if p == "mesh" else None)
                walls[p].append(time.perf_counter() - t0)
                check(e == enc and v == verdicts, f"{label}: warm flush {r} ({p}) differs")
                if p == "mesh":
                    warm.append(dict(b.last_timings))
        log(f"{label} warm, 4 flushes in turns, median (q1, q3) ms: mesh "
            f"{median_line(walls['mesh'])}, one card {median_line(walls['card'])}")
    return total, warm


# ---------------------------------------------------------------------------
# the HoneyBadger era: the consensus protocols and both flush batchers
# ---------------------------------------------------------------------------

HB_N, HB_F = 64, 21
HB_CHECK_N, HB_CHECK_F = 16, 5
HB_MAX_MESSAGES = 6_000_000
# the rings of a traced root era (utils/tracing.py's merged rings, the
# native engine's): large enough that an N=64 era drops no event
TRACE_CAPACITY = 1 << 20
TRANSFER_BYTES = 177  # a signed transfer (lachain_tpu/core/types.py:80)
ROOT_CHAIN_ID = 225
# the producer's fixed state hash (tests/test_torch_root_protocol.py's)
ROOT_STATE_HASH = b"\x5a" * 32
# transfers a validator at the N=16 check: its plain run recovers the
# block's senders on the host's plain kernels, ~70 ms a signature
ROOT_CHECK_TXS = 8
# the N=16 chaos era's schedule, in delivered messages: the unfaulted era
# (TAKE_FIRST, ROOT_CHECK_TXS transfers a validator) delivers 45,743, so
# router 3 is down from ~10% to ~40% of it and {0,1,2,3} | {12,...,15}
# split from ~5% to ~30%
CHAOS_CRASH = (4_500, 18_000)
CHAOS_PARTITION = (2_300, 13_700)
# the crash of the native journal phase, in delivered messages: about half
# of root_era_native_64's 2,894,527; the native engine stops at the first
# chunk boundary past it (the N=16 Python journal era crashes at half of
# its own run A's messages)
CRASH_AT = 1_450_000
# the kinds of send slot (consensus/journal.send_slot) the Python engine's
# root era journals
LATCHED_KINDS = {"val", "echo", "ready", "bval", "aux", "conf", "coin", "dec", "hdr"}


def root_transfers(n: int, per: int, rng: random.Random):
    """Every validator's proposal: `per` seeded transfers of TRANSFER_BYTES,
    signed with the native `sign_hash` by N_SENDERS seeded sender keys in
    turn (nonces counting per sender) -> (proposals, {tx hash: its
    signer's address})."""
    from lachain_tpu_torch.core import types
    from lachain_tpu_torch.crypto import ecdsa

    keys = [rng.randrange(1, ecdsa.N).to_bytes(32, "big") for _ in range(N_SENDERS)]
    addrs = [ecdsa.address_from_public_key(ecdsa.public_key_bytes(k)) for k in keys]
    proposals, signer = [], {}
    for i in range(n):
        batch = []
        for j in range(per):
            k = i * per + j
            tx = types.Transaction(to=rng.randbytes(20), value=rng.randrange(1, 10**21),
                                   nonce=k // N_SENDERS, gas_price=rng.randrange(1, 10**11),
                                   gas_limit=21000)
            stx = types.sign_transaction(tx, keys[k % N_SENDERS], ROOT_CHAIN_ID)
            check(len(stx.encode()) == TRANSFER_BYTES, "a transfer is not 177 bytes")
            signer[stx.hash()] = addrs[k % N_SENDERS]
            batch.append(stx)
        proposals.append(batch)
    return proposals, signer


class RootProducer:
    """The producer seam of consensus.root_protocol.RootProtocol (the shape
    of the reference's BlockProducer), filled as the reference's devnet and
    tests fill it but with no chain state: it proposes its validator's
    transfers; the header and the block recover every sender in one batch
    (core/types.warm_sender_caches on `device`, as BlockManager.
    execute_block does before it orders), order the transactions as the
    reference's block manager does (sender, nonce, hash), and build the
    header over `parent`, ROOT_STATE_HASH, the Merkle root of the ordered
    hashes and the coin's nonce. The validators of one process share the
    decoded transactions (core/block_producer's memo), so the first header
    of the era recovers the block's senders and every later call finds
    them cached. `recover_s`: seconds in warm_sender_caches."""

    def __init__(self, txs, device, parent: bytes):
        self._txs, self._device, self._parent = txs, device, parent
        self.recover_s = 0.0

    def get_transactions_to_propose(self):
        return list(self._txs)

    def _ordered(self, txs):
        from lachain_tpu_torch.core import types

        t0 = time.perf_counter()
        types.warm_sender_caches(txs, ROOT_CHAIN_ID, device=self._device)
        self.recover_s += time.perf_counter() - t0
        return sorted(txs, key=lambda stx: (stx.sender(ROOT_CHAIN_ID) or b"\xff" * 20,
                                            stx.tx.nonce, stx.hash()))

    def create_header(self, index, txs, nonce):
        from lachain_tpu_torch.core import types

        ordered = self._ordered(txs)
        return types.BlockHeader(
            index=index, prev_block_hash=self._parent,
            merkle_root=types.tx_merkle_root([t.hash() for t in ordered]),
            state_hash=ROOT_STATE_HASH, nonce=nonce)

    def produce_block(self, header, txs, multisig):
        from lachain_tpu_torch.core import types

        ordered = self._ordered(txs)
        return types.Block(header=header, tx_hashes=tuple(t.hash() for t in ordered),
                           multisig=multisig)


def root_factories(pub, privs, proposals, device, parent: bytes):
    """extra_factories of a root era: validator i's RootProtocol over its
    RootProducer, as the JAX package's devnet wires them
    (lachain_tpu/core/devnet.py:148-159) -> (factories, producers)."""
    from lachain_tpu_torch.consensus import messages as M
    from lachain_tpu_torch.consensus.root_protocol import RootProtocol

    producers = [RootProducer(txs, device, parent) for txs in proposals]

    def make(pid, router):
        i = router.my_id
        return RootProtocol(pid, router, producer=producers[i],
                            ecdsa_priv=privs[i].ecdsa_priv, ecdsa_pubs=pub.ecdsa_pub_keys)
    return {M.RootProtocolId: make}, producers


def root_era_inputs(seed: int):
    """The N=64 root eras' keys, proposals (BLOCK_TXS / HB_N signed
    transfers a validator) and parent -> (pub, privs, proposals, signer,
    parent)."""
    from lachain_tpu_torch.consensus.keys import trusted_key_gen

    pub, privs = trusted_key_gen(HB_N, HB_F, SeededRng(seed + 640))
    rng = random.Random(seed + 641)
    proposals, signer = root_transfers(HB_N, -(-BLOCK_TXS // HB_N), rng)
    return pub, privs, proposals, signer, rng.randbytes(32)


def clear_block_memos() -> None:
    """Drop the process-wide decoded proposals and recovered senders, so
    that the next era recovers its block's senders again."""
    from lachain_tpu_torch.core import block_producer, types

    block_producer._DECODE_MEMO.clear()
    types._SENDER_MEMO.clear()


class MaliciousHoneyBadger(HoneyBadger):
    """A HoneyBadger that broadcasts a corrupted decryption share (its
    point times 1337) for every slot, as the JAX package's
    tests/test_consensus_byzantine.MaliciousHoneyBadger does: router 0's in
    both root checks (through MaliciousRouter on the Python engine, through
    `_extra_factories` on the native one)."""

    def handle_child_result(self, child_id, value):
        from lachain_tpu_torch.consensus import messages as M
        from lachain_tpu_torch.crypto import bls12381 as bls
        from lachain_tpu_torch.crypto import tpke

        if not isinstance(child_id, M.CommonSubsetId) or self._ciphertexts is not None:
            return super().handle_child_result(child_id, value)
        self._ciphertexts = {}
        for slot, blob in value.items():
            try:
                share = tpke.EncryptedShare.from_bytes(blob, self.host)
            except (ValueError, AssertionError):
                self._plaintexts[slot] = None
                continue
            self._ciphertexts[slot] = share
            dec = self._priv.tpke_priv.decrypt_share(share, backend=self.host)
            bad = tpke.PartiallyDecryptedShare(
                bls.g1_mul(dec.ui, 1337), dec.decryptor_id, dec.share_id)
            self.broadcaster.broadcast(
                M.DecryptedMessage(hb=self.id, share_id=slot, payload=bad.to_bytes()))


def malicious_honey_badger(pid, router):
    """The `_extra_factories[HoneyBadgerId]` entry of a malicious router."""
    return MaliciousHoneyBadger(pid, router, router.public_keys, router.private_keys)


def malicious_router_cls():
    """An EraRouter whose HoneyBadger is a MaliciousHoneyBadger, as the JAX
    package's tests/test_consensus_byzantine.MaliciousRouter."""
    from lachain_tpu_torch.consensus import messages as M
    from lachain_tpu_torch.consensus.era import EraRouter

    class MaliciousRouter(EraRouter):
        def _create(self, pid):
            if isinstance(pid, M.HoneyBadgerId):
                return malicious_honey_badger(pid, self)
            return super()._create(pid)

    return MaliciousRouter


def root_run(net, live) -> tuple:
    """Every validator starts its RootProtocol; the network runs to every
    live router's block -> (wall seconds, live blocks)."""
    from lachain_tpu_torch.consensus import messages as M

    pid = M.RootProtocolId(era=0)
    t0 = time.perf_counter()
    for i in range(net.n):
        net.post_request(i, pid, None)
    check(net.run(lambda: all(net.routers[i].result_of(pid) is not None for i in live),
                  max_messages=HB_MAX_MESSAGES), "the era did not finish")
    return time.perf_counter() - t0, [net.routers[i].result_of(pid) for i in live]


def check_root_blocks(label: str, net, blocks, live, proposals, signer, pub, n: int,
                      f: int) -> None:
    """Every live router returned a Block, all with one header hash and
    one transaction list; HoneyBadger agreed on at least n - f slots, each
    its proposer's batch; the block holds exactly those slots'
    transactions, each sender recovered in the producers' batch and its
    signer's address, in the reference's order; each multisig has at least n - f entries, every one verifying
    natively under its validator's key."""
    from lachain_tpu_torch.consensus import messages as M
    from lachain_tpu_torch.core import block_producer, types
    from lachain_tpu_torch.crypto import ecdsa

    check(all(isinstance(b, types.Block) for b in blocks), f"{label}: a router gave no Block")
    h = blocks[0].header.hash()
    check(all(b.header.hash() == h and b.tx_hashes == blocks[0].tx_hashes for b in blocks),
          f"{label}: the routers' blocks differ")
    slots = net.routers[live[0]].result_of(M.HoneyBadgerId(era=0))
    check(len(slots) >= n - f, f"{label}: {len(slots)} slots < n - f")
    check(all(pt == block_producer.encode_tx_batch(proposals[j]) for j, pt in slots.items()),
          f"{label}: a slot differs from its proposer's batch")
    want = {t.hash() for j in slots for t in proposals[j]}
    check(set(blocks[0].tx_hashes) == want and len(blocks[0].tx_hashes) == len(want),
          f"{label}: the block's transactions are not the agreed slots'")
    # the objects the routers decoded (the memo's), whose senders the
    # producers' batch recovery cached
    txs = {t.hash(): t for pt in slots.values() for t in block_producer.decode_tx_batch(pt)}
    check(all("_sender_cache" in t.__dict__ for t in txs.values()),
          f"{label}: a sender was not recovered in the producers' batch")
    senders = [txs[x].sender(ROOT_CHAIN_ID) for x in blocks[0].tx_hashes]
    check(senders == [signer[x] for x in blocks[0].tx_hashes],
          f"{label}: a sender is not its signer's address")
    check(senders == sorted(senders), f"{label}: the block is not in sender order")
    for b in blocks:
        sigs = b.multisig.signatures
        check(len(sigs) >= n - f and all(
            ecdsa.verify_hash(pub.ecdsa_pub_keys[i], h, sig) for i, sig in sigs),
            f"{label}: a multisig has fewer than n - f valid signatures")


def root_seconds(net, producers) -> dict:
    """The header round's summed sign / verify seconds over the routers (a
    native router's RootHost or a Python router's RootProtocol), and the
    block recovery's (the producers' warm_sender_caches)."""
    from lachain_tpu_torch.consensus import messages as M

    roots = [r.native_root(0) if hasattr(r, "native_root")
             else r.protocol(M.RootProtocolId(era=0)) for r in net.routers]
    return dict(sign_s=sum(p.sign_s for p in roots if p is not None),
                verify_s=sum(p.verify_s for p in roots if p is not None),
                recover_s=sum(p.recover_s for p in producers))


def batcher_lines(label: str, net) -> None:
    tb, rb = net.crypto_batcher, net.rbc_batcher
    log(f"{label} tpke batcher: {tb.flushes} flushes, {tb.slots_flushed} slots, "
        f"{tb.deduped_slots} deduped, {tb.chunks} chunks; summed phases: "
        f"{phase_line(net.tpke_phase_s)}")
    log(f"{label} rbc batcher: {rb.flushes} flushes, {rb.items} items, {rb.deduped} "
        f"deduped, {rb.memo_hits} memo hits; summed phases: {phase_line(net.rbc_phase_s)}")


def begin_traced_era() -> dict:
    """Start a traced root era afresh: the merged tracer and the per-era
    evidence counts emptied (an earlier path's or an earlier trace's)
    and the tracer's rings TRACE_CAPACITY -> the counters the era's checks
    take deltas of. check_era_report empties them again at its end, back
    to the default rings, so that later paths keep no N=64 trace alive."""
    from lachain_tpu_torch.consensus import evidence
    from lachain_tpu_torch.utils import metrics, tracing

    tracing.reset_for_tests()
    tracing.set_capacity(TRACE_CAPACITY)
    evidence.reset_era_counts()
    return dict(processed=messages_processed(), native_dropped=metrics.counter_value(
        "trace_events_dropped_total", labels={"source": "consensus"}))


def messages_processed() -> float:
    """consensus_messages_processed with its hot-path cell folded in."""
    from lachain_tpu_torch.utils import metrics

    return metrics.MESSAGES_PROCESSED[0] + metrics.counter_value("consensus_messages_processed")


def check_era_report(label: str, net, before: dict, native: bool) -> dict:
    """The era report of a traced root era (utils/tracing.era_report over
    the era span the harness opened, era 0): printed as its table and its
    critical path (the 5 longest segments; every segment in
    chiprun_out/critical_path_<label>.txt); checked: one era, no event
    dropped by either ring, phases + named waits + idle_unattributed equal
    to the era wall within 10% (the reference's acceptance tolerance;
    `coverage` is the report's own sum over the wall), the TPKE flush's
    decryptions and the RS launches in tpke_decrypt and rbc_device time,
    and consensus_messages_processed against delivered_count: on the
    Python engine every delivery reaches one protocol instance, whose
    internal requests and results add to it (>=), on the native engine no
    message reaches a Python protocol (0, no opaque crossing); on the
    native engine the drained cross:* events count each crossing op as
    `net.crossings` does -> the era's entry."""
    import collections
    import os

    from lachain_tpu_torch.consensus.native_hosts import XO_NAMES
    from lachain_tpu_torch.utils import metrics, tracing

    report = tracing.era_report()
    check([e["era"] for e in report["eras"]] == [0],
          f"{label}: the report's eras {[e['era'] for e in report['eras']]} != [0]")
    ent = report["eras"][0]
    for line in tracing.era_report_table(report).splitlines():
        log(f"{label} era report: {line}")
    cp = ent["critical_path"]
    log(f"{label} critical path: {cp['total_s']:.3f} s of the {ent['wall_s']:.3f} s wall in "
        f"{len(cp['segments'])} segments; longest {cp['top']}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"critical_path_{label.replace(' ', '_')}.txt"),
              "w") as fh:
        fh.write(tracing.critical_path_table(report) + "\n")
    py_dropped = tracing.dropped_total()
    native_dropped = metrics.counter_value(
        "trace_events_dropped_total", labels={"source": "consensus"}) - before["native_dropped"]
    check(py_dropped == 0 and native_dropped == 0,
          f"{label}: the rings dropped {py_dropped} spans and {native_dropped} native events")
    waits = sum(ent["waits_s"].values())
    total = sum(ent["phases_s"].values()) + waits + ent["idle_unattributed_s"]
    check(abs(total - ent["wall_s"]) <= 0.10 * ent["wall_s"],
          f"{label}: phases + waits + unattributed {total:.6f} s, the wall {ent['wall_s']:.6f} s")
    check(ent["phases_s"]["tpke_decrypt"] > 0 and ent["phases_s"]["rbc_device"] > 0,
          f"{label}: no tpke_decrypt or rbc_device time: {ent['phases_s']}")
    processed = messages_processed() - before["processed"]
    spans = tracing.snapshot()
    if native:
        crossed = collections.Counter(
            e["args"]["op"] for e in tracing.native_snapshot() if e["cat"] == "native.cross")
        want = {op: net.crossings[op] for op in XO_NAMES.values() if net.crossings[op]}
        check(dict(crossed) == want, f"{label}: cross events {dict(crossed)} != {want}")
        check(processed == 0 and net.crossings["opaque_message"] == 0,
              f"{label}: {processed} messages reached a Python protocol")
    else:
        check(processed >= net.delivered_count,
              f"{label}: {processed} messages processed < {net.delivered_count} delivered")
    log(f"{label} era report: coverage {ent['coverage']}, phases + waits + unattributed "
        f"{total:.6f} s of the {ent['wall_s']:.6f} s wall; {len(spans)} spans, "
        f"{len(tracing.native_snapshot())} native events, 0 dropped; "
        f"consensus_messages_processed {processed:.0f}, delivered_count "
        f"{net.delivered_count}" + (f", cross events {dict(crossed)}" if native else ""))
    tracing.reset_for_tests()
    return ent


def run_root_era_path(seed: int, dev, ref=None):
    """The N=64, f=21 root era through SimulatedNetwork on the card
    (TAKE_FIRST, both batchers): every validator's RootProtocol proposes
    its 16 signed transfers into HoneyBadger, signs the header, and makes
    the block at N - f signatures, its senders recovered on the card;
    traced whole by torch.profiler: the wall, the messages, each batcher's
    flushes and summed phases, the coins' host seconds, the header round's
    sign / verify seconds, the block recovery's phases, and the card's
    busy share of the wall (the trace's device time). `ref`, a dict, gets
    the block's header hash and the delivered_count, which the native
    engine's era must equal."""
    import torch

    from lachain_tpu_torch.consensus.simulator import DeliveryMode, SimulatedNetwork
    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.utils import tracing

    label = f"root era N={HB_N}"
    t0 = time.perf_counter()
    pub, privs, proposals, signer, parent = root_era_inputs(seed)
    log(f"{label}: host setup (dealer, {HB_N} proposals of {len(proposals[0])} signed "
        f"transfers, {len(signer)} signatures): {time.perf_counter() - t0:.1f} s")
    out = {}

    def era():
        clear_block_memos()
        reset_counts()
        out["before"] = begin_traced_era()
        factories, producers = root_factories(pub, privs, proposals, dev, parent)
        net = SimulatedNetwork(pub, privs, seed=seed, mode=DeliveryMode.TAKE_FIRST,
                               use_rbc_batcher=True, device=dev, extra_factories=factories)
        with tracing.span("era", era=0):
            out["wall"], out["blocks"] = root_run(net, range(HB_N))
        out["launches"] = read_launches()
        out["net"], out["producers"] = net, producers

    def warm():
        torch.arange(1 << 12, device=dev).sum().item()

    by_kernel = profile_device(era, warm=warm)
    net, wall, launches, blocks = out["net"], out["wall"], out["launches"], out["blocks"]
    check_no_escapes(label)
    check_root_blocks(label, net, blocks, list(range(HB_N)), proposals, signer, pub,
                      HB_N, HB_F)
    traced = {k: by_kernel.get(KERNEL_OF[k], [0, 0])[1] for k in launches if launches[k]}
    counted = {k: v for k, v in launches.items() if v}
    secs = root_seconds(net, out["producers"])
    rec = ecdsa.batch_recoverer(dev).last_timings
    log(f"{label}: every router made block {blocks[0].header.hash().hex()[:16]} "
        f"({len(blocks[0].tx_hashes)} transfers, {len(blocks[0].multisig.signatures)} "
        f"signatures); wall {wall:.3f} s, {net.delivered_count} messages "
        f"({net.delivered_count / wall:.0f} a second); coin combines {net.coin_s:.3f} s "
        f"on the host")
    log(f"{label}: header round sign {secs['sign_s']:.3f} s, verify {secs['verify_s']:.3f} s "
        f"(summed over the routers); block recovery {secs['recover_s']:.3f} s, "
        f"last_timings {rec}")
    batcher_lines(label, net)
    log(f"{label}: launches {counted}, traced {traced}"
        + ("" if traced == counted else " (the trace lost launches)"))
    busy_line(label, by_kernel, wall)
    check_era_report("root_era_64", net, out["before"], native=False)
    if ref is not None:
        ref.update(hash=blocks[0].header.hash(), delivered=net.delivered_count, wall=wall)
    return launches, [dict(wall_s=wall, **secs)]


def trace_era(label: str, era, out: dict, dev, tries: int = 3):
    """profile_device(era), traced whole after two tiny warm-up steps, and
    again (at most `tries` traces) while the trace lost device activities;
    era() leaves its counted launches in out["launches"] -> (by_kernel,
    the counted launches)."""
    import torch

    def warm():
        torch.arange(1 << 12, device=dev).sum().item()

    for i in range(tries):
        by_kernel = profile_device(era, warm=warm)
        counted = {k: v for k, v in out["launches"].items() if v}
        traced = {k: by_kernel.get(KERNEL_OF[k], [0, 0])[1] for k in counted}
        if traced == counted:
            break
        log(f"{label}: the trace lost device activities (trace {i + 1} of {tries}): "
            f"{traced} != {counted}")
    return by_kernel, counted


def native_root_net(pub, privs, proposals, device, parent: bytes, seed: int, mode,
                    **kw):
    """The root era on consensus/native_rt.NativeSimulatedNetwork (both
    batchers; `kw` its other arguments) on `device`, every validator's
    RootProtocol hosted natively through set_root_context over its
    RootProducer -> (net, producers)."""
    from lachain_tpu_torch.consensus.native_rt import NativeSimulatedNetwork

    producers = [RootProducer(txs, device, parent) for txs in proposals]
    net = NativeSimulatedNetwork(pub, privs, seed=seed, mode=mode, use_rbc_batcher=True,
                                 device=device, **kw)
    for i, producer in enumerate(producers):
        net.set_root_context(i, producer, privs[i].ecdsa_priv, pub.ecdsa_pub_keys)
    return net, producers


def check_native_crossings(label: str, net, n: int) -> None:
    """The native era crossed into Python only through the batched ops: no
    per-message opaque, ACS or coin-request callback; one ACS result and
    one block a validator."""
    c = net.crossings
    check(c["opaque_message"] == c["acs_result"] == c["coin_request"] == 0,
          f"{label}: per-message crossings {c}")
    check(c["hb_acs"] == n and c["root_produce"] == n,
          f"{label}: hb_acs / root_produce != {n}: {c}")
    check(net.native_handled() > 0, f"{label}: the engine handled no message natively")


def run_root_native_path(seed: int, dev, ref=None):
    """root_era_64's era (same keys, proposals, parent and seed; N=64,
    f=21, TAKE_FIRST, both batchers) through the native consensus engine
    (consensus/native_rt.NativeSimulatedNetwork) on the card, RootProtocol
    hosted natively at every validator (set_root_context), traced whole by
    torch.profiler: the checks of root_era_64, the same block hash and
    delivered_count as root_era_64 (`ref`; TAKE_FIRST runs one schedule on
    both engines), no per-message crossing, traced launches equal to the
    counted ones; printed: the wall, messages a second, the engine's
    natively handled messages, the crossings, each batcher's flushes and
    summed phases, the coins' seconds, the header round, the block
    recovery and the busy share."""
    from lachain_tpu_torch.consensus.simulator import DeliveryMode
    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.utils import tracing

    label = f"native root era N={HB_N}"
    pub, privs, proposals, signer, parent = root_era_inputs(seed)
    out = {}

    def era():
        clear_block_memos()
        reset_counts()
        out["before"] = begin_traced_era()
        net, producers = native_root_net(pub, privs, proposals, dev, parent, seed,
                                          DeliveryMode.TAKE_FIRST)
        net.trace_configure(TRACE_CAPACITY)
        with tracing.span("era", era=0):
            out["wall"], out["blocks"] = root_run(net, range(HB_N))
        out["launches"] = read_launches()
        out["net"], out["producers"] = net, producers

    by_kernel, counted = trace_era(label, era, out, dev)
    net, wall, blocks, launches = out["net"], out["wall"], out["blocks"], out["launches"]
    check_no_escapes(label)
    check_root_blocks(label, net, blocks, list(range(HB_N)), proposals, signer, pub,
                      HB_N, HB_F)
    check_native_crossings(label, net, HB_N)
    check_traced(label, by_kernel, launches, counted)
    h = blocks[0].header.hash()
    if ref is not None:
        check(h == ref["hash"] and net.delivered_count == ref["delivered"],
              f"{label}: block {h.hex()[:16]} / {net.delivered_count} messages, the "
              f"Python engine's {ref['hash'].hex()[:16]} / {ref['delivered']}")
        log(f"{label}: the same block and messages as root_era_64's (its wall "
            f"{ref['wall']:.3f} s)")
    secs = root_seconds(net, out["producers"])
    rec = ecdsa.batch_recoverer(dev).last_timings
    log(f"{label}: every router made block {h.hex()[:16]} ({len(blocks[0].tx_hashes)} "
        f"transfers, {len(blocks[0].multisig.signatures)} signatures); wall {wall:.3f} s, "
        f"{net.delivered_count} messages ({net.delivered_count / wall:.0f} a second), "
        f"{net.native_handled()} handled natively; coin combines {net.coin_s:.3f} s on "
        f"the host")
    log(f"{label}: crossings {net.crossings}")
    log(f"{label}: header round sign {secs['sign_s']:.3f} s, verify {secs['verify_s']:.3f} s "
        f"(summed over the routers); block recovery {secs['recover_s']:.3f} s, "
        f"last_timings {rec}")
    batcher_lines(label, net)
    busy_line(label, by_kernel, wall)
    check_era_report("root_era_native_64", net, out["before"], native=True)
    net.close()
    if ref is not None:
        ref["native_wall"] = wall
    return launches, [dict(wall_s=wall, **secs)]


def run_root_native_untraced_path(seed: int, dev, ref):
    """root_era_native_64's era once more with the engine's flight
    recorder at capacity 0 (no record, no clock read on its hot path): the
    same block hash and delivered_count as root_era_64 (`ref`), so a traced
    era equals an untraced one; its wall beside root_era_native_64's."""
    from lachain_tpu_torch.consensus.simulator import DeliveryMode

    label = f"native root era N={HB_N} untraced"
    pub, privs, proposals, signer, parent = root_era_inputs(seed)
    clear_block_memos()
    reset_counts()
    net, _producers = native_root_net(pub, privs, proposals, dev, parent, seed,
                                      DeliveryMode.TAKE_FIRST)
    net.trace_configure(0)
    wall, blocks = root_run(net, range(HB_N))
    launches = read_launches()
    check_no_escapes(label)
    check_root_blocks(label, net, blocks, list(range(HB_N)), proposals, signer, pub,
                      HB_N, HB_F)
    h = blocks[0].header.hash()
    check(h == ref["hash"] and net.delivered_count == ref["delivered"],
          f"{label}: block {h.hex()[:16]} / {net.delivered_count} messages, root_era_64's "
          f"{ref['hash'].hex()[:16]} / {ref['delivered']}")
    check(net.trace_dropped() == 0, f"{label}: the recorder at capacity 0 dropped records")
    log(f"{label}: recorder off: block {h.hex()[:16]} and {net.delivered_count} messages, "
        f"root_era_64's; wall {wall:.3f} s (root_era_native_64, recorder on and traced by "
        f"torch.profiler: {ref['native_wall']:.3f} s)")
    net.close()
    return launches, [dict(wall_s=wall)]


def check_backend(device):
    """The backend of an N=16 check's leg: the card's default, or on the
    CPU the era on the host pipeline over the native host library (the
    kernels' plain versions are held in phase 2 already, at full width).
    The leg's RBC batcher and block recovery run on `device` all the same,
    the plain versions on the CPU."""
    if device == "cpu":
        from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
        from lachain_tpu_torch.crypto.native_backend import NativeBackend
        from lachain_tpu_torch.ops.verify import HostEraPipeline

        host = NativeBackend()
        return GpuBackend(device="cpu", host_backend=host, pipeline=HostEraPipeline(host))
    return None


def run_root_native_check_path(seed: int, dev):
    """root_era_16_check's era (N=16, f=5, TAKE_RANDOM, both batchers,
    ROOT_CHECK_TXS transfers a validator) through the native engine, router
    0's HoneyBadger malicious through `_extra_factories` (which keeps its
    HoneyBadger and its RootProtocol in Python, their messages crossing the
    engine as opaque payloads), once on the card and once with device="cpu"
    (the era on the host pipeline, check_backend; the RBC batcher and the
    block's sender recovery on the plain versions), each recovering its
    block's senders afresh: equal
    blocks at every honest router, equal delivered_count, flush counts and
    evidence (every honest router convicts exactly router 0, invalid_share,
    "dec")."""
    from lachain_tpu_torch.consensus import messages as M
    from lachain_tpu_torch.consensus.keys import trusted_key_gen
    from lachain_tpu_torch.consensus.simulator import DeliveryMode

    label = f"native root era check N={HB_CHECK_N}"
    n, f = HB_CHECK_N, HB_CHECK_F
    pub, privs = trusted_key_gen(n, f, SeededRng(seed + 160))
    rng = random.Random(seed + 161)
    proposals, signer = root_transfers(n, ROOT_CHECK_TXS, rng)
    parent = rng.randbytes(32)
    outcomes, launches = [], None
    live = list(range(1, n))
    for device in (dev, "cpu"):
        clear_block_memos()
        reset_counts()
        net, producers = native_root_net(pub, privs, proposals, device, parent, seed,
                                         DeliveryMode.TAKE_RANDOM,
                                         backend=check_backend(device))
        net.routers[0]._extra_factories = {M.HoneyBadgerId: malicious_honey_badger}
        wall, blocks = root_run(net, live)
        if launches is None:
            launches, card_wall = read_launches(), wall
            check_no_escapes(label)
        check_root_blocks(f"{label} on {device}", net, blocks, live, proposals, signer,
                          pub, n, f)
        evidence = [net.routers[i].evidence.snapshot() for i in live]
        want = {("invalid_share", 0, "dec")}
        check(all({(r["kind"], r["offender"], r["proto"]) for r in ev} == want
                  for ev in evidence),
              f"{label} on {device}: evidence {evidence[0]} is not router 0's dec shares")
        check(net.crossings["opaque_message"] > 0 and net.native_handled() > 0,
              f"{label} on {device}: router 0's Python protocols sent nothing through "
              f"the engine ({net.crossings})")
        outcomes.append(([b.encode() for b in blocks], net.delivered_count,
                         net.crypto_batcher.flushes, net.rbc_batcher.flushes, evidence))
        secs = root_seconds(net, producers)
        log(f"{label} on {device}: block of {len(blocks[0].tx_hashes)} transfers, wall "
            f"{wall:.3f} s, {net.delivered_count} messages, {len(evidence[0])} evidence "
            f"records at each honest router; block recovery {secs['recover_s']:.3f} s; "
            f"crossings {net.crossings}")
        batcher_lines(f"{label} on {device}", net)
        net.close()
    check(outcomes[0] == outcomes[1], f"{label}: the card's era differs from the plain one")
    log(f"{label}: the card's era equals the plain versions' (blocks, messages, "
        f"flushes, evidence)")
    return launches, [{"wall_s": card_wall}]


def run_root_check_path(seed: int, dev):
    """The N=16, f=5 root era in TAKE_RANDOM with router 0 malicious
    (corrupted decryption shares), once on the card and once with
    device="cpu" (the era on the host pipeline, check_backend; the RBC
    batcher and the block's sender recovery on the plain versions), each
    recovering its block's senders afresh: equal
    blocks at every honest router, equal delivered_count, equal flush
    counts, and equal evidence: every honest router convicts exactly
    router 0, kind invalid_share, proto "dec"."""
    from lachain_tpu_torch.consensus.keys import trusted_key_gen
    from lachain_tpu_torch.consensus.simulator import DeliveryMode, SimulatedNetwork

    label = f"root era check N={HB_CHECK_N}"
    n, f = HB_CHECK_N, HB_CHECK_F
    pub, privs = trusted_key_gen(n, f, SeededRng(seed + 160))
    rng = random.Random(seed + 161)
    proposals, signer = root_transfers(n, ROOT_CHECK_TXS, rng)
    parent = rng.randbytes(32)
    bad_router = malicious_router_cls()
    outcomes, launches = [], None
    live = list(range(1, n))
    for device in (dev, "cpu"):
        clear_block_memos()
        reset_counts()
        factories, producers = root_factories(pub, privs, proposals, device, parent)
        net = SimulatedNetwork(pub, privs, seed=seed, mode=DeliveryMode.TAKE_RANDOM,
                               use_rbc_batcher=True, device=device,
                               backend=check_backend(device), extra_factories=factories)
        net.routers[0] = net.make_router(0, 0, pub, privs[0], extra_factories=factories,
                                         router_cls=bad_router)
        wall, blocks = root_run(net, live)
        if launches is None:
            launches, card_wall = read_launches(), wall
            check_no_escapes(label)
        check_root_blocks(f"{label} on {device}", net, blocks, live, proposals, signer,
                          pub, n, f)
        evidence = [net.routers[i].evidence.snapshot() for i in live]
        want = {("invalid_share", 0, "dec")}
        check(all({(r["kind"], r["offender"], r["proto"]) for r in ev} == want
                  for ev in evidence),
              f"{label} on {device}: evidence {evidence[0]} is not router 0's dec shares")
        outcomes.append(([b.encode() for b in blocks], net.delivered_count,
                         net.crypto_batcher.flushes, net.rbc_batcher.flushes, evidence))
        secs = root_seconds(net, producers)
        log(f"{label} on {device}: block of {len(blocks[0].tx_hashes)} transfers, wall "
            f"{wall:.3f} s, {net.delivered_count} messages, {len(evidence[0])} evidence "
            f"records at each honest router; block recovery {secs['recover_s']:.3f} s")
        batcher_lines(f"{label} on {device}", net)
    check(outcomes[0] == outcomes[1], f"{label}: the card's era differs from the plain one")
    log(f"{label}: the card's era equals the plain versions' (blocks, messages, "
        f"flushes, evidence)")
    return launches, [{"wall_s": card_wall}]


def adversary_era_inputs(seed: int, n: int = HB_N, f: int = HB_F):
    """The adversary eras' keys, proposals and parent (at N=64 root_era_64's;
    at N=16 seeded apart, BLOCK_TXS / HB_N transfers a validator, as at
    N=64) and f equivocating validators (every third from 1) -> (pub,
    privs, proposals, signer, parent, plan, honest)."""
    from lachain_tpu_torch.consensus.adversary import AdversaryPlan
    from lachain_tpu_torch.consensus.keys import trusted_key_gen

    if n == HB_N:
        pub, privs, proposals, signer, parent = root_era_inputs(seed)
    else:
        pub, privs = trusted_key_gen(n, f, SeededRng(seed + 2640))
        rng = random.Random(seed + 2641)
        proposals, signer = root_transfers(n, -(-BLOCK_TXS // HB_N), rng)
        parent = rng.randbytes(32)
    plan = AdversaryPlan("equivocate", traitors=tuple(range(1, n, 3)), seed=seed)
    honest = [i for i in range(n) if i not in plan.traitors]
    return pub, privs, proposals, signer, parent, plan, honest


def check_equivocation_verdict(label: str, net, honest, traitors) -> list:
    """Every honest router convicts exactly the traitors, of equivocation
    only, each traitor in "dec", in no slot but "dec" and "coin"; no
    invalid_share (the variants were latched away before any combine) ->
    the honest routers' record sets."""
    evidence = [net.routers[i].evidence.record_set() for i in honest]
    for i, recs in zip(honest, evidence):
        check({r.offender for r in recs} == set(traitors)
              and {r.kind for r in recs} == {"equivocation"}
              and {r.proto for r in recs} <= {"dec", "coin"}
              and {r.offender for r in recs if r.proto == "dec"} == set(traitors),
              f"{label}: router {i}'s evidence is not the traitors' equivocations: "
              f"{net.routers[i].evidence.counts()}, offenders "
              f"{sorted({r.offender for r in recs})}, protos {sorted({r.proto for r in recs})}")
    return evidence


@contextlib.contextmanager
def quiet_era_log():
    """The era router logs a warning a detected equivocation (~60k in the
    N=64 adversary era); those are dropped and their evidence counts
    printed instead. Every other record of the era's logger still shows."""
    logger = logging.getLogger("lachain_tpu_torch.consensus.era")

    def keep(record) -> bool:
        return not str(record.msg).startswith("equivocation from")

    logger.addFilter(keep)
    try:
        yield
    finally:
        logger.removeFilter(keep)


def evidence_line(net, honest) -> str:
    counts = [net.routers[i].evidence.counts() for i in honest]
    protos: dict = {}
    for i in honest:
        for r in net.routers[i].evidence.records():
            protos[r.proto] = protos.get(r.proto, 0) + 1
    return (f"{sum(c['equivocation'] for c in counts)} equivocation and "
            f"{sum(c['invalid_share'] for c in counts)} invalid_share records over the "
            f"{len(honest)} honest routers ({len(net.routers[honest[0]].evidence)} at each; "
            f"by slot {protos})")


def run_root_adversary_native_path(seed: int, dev, ref=None, n: int = HB_N, f: int = HB_F,
                                   traced: bool = True):
    """root_era_64's era (keys, proposals, parent and seed; N=64, f=21,
    TAKE_FIRST, both batchers; at n = 16 adversary_era_inputs' N=16 era)
    through the native engine on the card with f = 21 equivocating
    validators (consensus/adversary.py, installed after
    the network is built and before the first request: the traitors'
    coin, HoneyBadger and Root run in Python, their messages crossing the
    engine as opaque payloads), RootProtocol native at the 43 honest
    validators (set_root_context at all 64), traced whole by torch.profiler:
    every honest router makes one block (root_era_64's checks); every
    honest router convicts exactly the 21 traitors of equivocation ("dec"
    for each, no slot but "dec" and "coin", no invalid_share); hb_acs and
    root_produce equal the 43 honest routers, opaque crossings > 0; traced
    launches equal to the counted ones (`traced`; the N=16 era, 0.7-1.0 s,
    runs untraced: in one call of three its trace lost the flushes'
    launches three times in a row). `ref`, a dict, gets the block hash,
    the messages and the honest routers' record sets, which the Python
    engine's era must equal. Printed: wall, messages a second,
    natively handled messages, crossings, the batchers, coins, the header
    round, the evidence counts, the busy share."""
    from lachain_tpu_torch.consensus import adversary
    from lachain_tpu_torch.consensus.simulator import DeliveryMode

    label = f"adversary native root era N={n}"
    pub, privs, proposals, signer, parent, plan, honest = adversary_era_inputs(seed, n, f)
    check(len(plan.traitors) == f, f"{label}: {len(plan.traitors)} traitors, not f")
    out = {}

    def era():
        clear_block_memos()
        reset_counts()
        net, producers = native_root_net(pub, privs, proposals, dev, parent, seed,
                                         DeliveryMode.TAKE_FIRST)
        adversary.install(plan, net)
        with quiet_era_log():
            out["wall"], out["blocks"] = root_run(net, honest)
        out["launches"] = read_launches()
        out["net"], out["producers"] = net, producers

    if traced:
        by_kernel, counted = trace_era(label, era, out, dev)
    else:
        era()
    net, wall, blocks, launches = out["net"], out["wall"], out["blocks"], out["launches"]
    check_no_escapes(label)
    check_root_blocks(label, net, blocks, honest, proposals, signer, pub, n, f)
    evidence = check_equivocation_verdict(label, net, honest, plan.traitors)
    c = net.crossings
    check(c["hb_acs"] == c["root_produce"] == len(honest) and c["opaque_message"] > 0,
          f"{label}: hb_acs / root_produce != {len(honest)} or no opaque crossing: {c}")
    check(net.native_handled() > 0, f"{label}: the engine handled no message natively")
    if traced:
        check_traced(label, by_kernel, launches, counted)
    h = blocks[0].header.hash()
    if ref is not None:
        ref.update(hash=h, delivered=net.delivered_count, evidence=evidence, wall=wall)
    secs = root_seconds(net, out["producers"])
    log(f"{label}: every honest router made block {h.hex()[:16]} "
        f"({len(blocks[0].tx_hashes)} transfers, {len(blocks[0].multisig.signatures)} "
        f"signatures); wall {wall:.3f} s, {net.delivered_count} messages "
        f"({net.delivered_count / wall:.0f} a second), {net.native_handled()} handled "
        f"natively; coin combines {net.coin_s:.3f} s on the host")
    log(f"{label}: crossings {c}")
    log(f"{label}: evidence {evidence_line(net, honest)}")
    log(f"{label}: header round sign {secs['sign_s']:.3f} s, verify {secs['verify_s']:.3f} s "
        f"(summed over the native routers); block recovery {secs['recover_s']:.3f} s")
    batcher_lines(label, net)
    if traced:
        busy_line(label, by_kernel, wall)
    net.close()
    return launches, [dict(wall_s=wall, **secs)]


def run_root_adversary_path(seed: int, dev, ref, n: int = HB_N, f: int = HB_F):
    """The native adversary era's era and plan (its `n`, `f`) on the
    Python engine (consensus/simulator.SimulatedNetwork, RootProtocol
    through extra_factories): root_era_64's checks at every honest router,
    the same verdict, and the native era's block hash and record sets
    (`ref`); its delivered_count is printed beside the native one's."""
    from lachain_tpu_torch.consensus import adversary
    from lachain_tpu_torch.consensus.simulator import DeliveryMode, SimulatedNetwork

    label = f"adversary root era N={n}"
    pub, privs, proposals, signer, parent, plan, honest = adversary_era_inputs(seed, n, f)
    clear_block_memos()
    reset_counts()
    factories, producers = root_factories(pub, privs, proposals, dev, parent)
    net = SimulatedNetwork(pub, privs, seed=seed, mode=DeliveryMode.TAKE_FIRST,
                           use_rbc_batcher=True, device=dev, extra_factories=factories)
    adversary.install(plan, net)
    with quiet_era_log():
        wall, blocks = root_run(net, honest)
    launches = read_launches()
    check_no_escapes(label)
    check_root_blocks(label, net, blocks, honest, proposals, signer, pub, n, f)
    evidence = check_equivocation_verdict(label, net, honest, plan.traitors)
    h = blocks[0].header.hash()
    check(h == ref["hash"], f"{label}: block {h.hex()[:16]}, the native engine's "
          f"{ref['hash'].hex()[:16]}")
    check(evidence == ref["evidence"], f"{label}: the honest routers' evidence differs "
          f"from the native engine's")
    secs = root_seconds(net, producers)
    log(f"{label}: every honest router made the native era's block {h.hex()[:16]} with its "
        f"evidence; wall {wall:.3f} s (native {ref['wall']:.3f}), {net.delivered_count} "
        f"messages (native {ref['delivered']}; {net.delivered_count / wall:.0f} a second); "
        f"coin combines {net.coin_s:.3f} s")
    log(f"{label}: evidence {evidence_line(net, honest)}; latch sheds "
        f"{sum(net.routers[i].shed['latch_cap'] for i in honest)}")
    batcher_lines(label, net)
    return launches, [dict(wall_s=wall, **secs)]


def run_root_adversary_16_path(seed: int, dev):
    """The adversary era at N=16, f=5 (5 equivocating validators; cut
    from the Python engine's N=64 era, whose attack stays at full width
    in root_era_adversary_native_64): the native engine's era
    (run_root_adversary_native_path, untraced), then the Python engine's
    (run_root_adversary_path) held to its block hash and record sets ->
    both runs' launches summed."""
    ref = {}
    native, warm_native = run_root_adversary_native_path(seed, dev, ref, HB_CHECK_N,
                                                         HB_CHECK_F, traced=False)
    python, warm_python = run_root_adversary_path(seed, dev, ref, HB_CHECK_N, HB_CHECK_F)
    return summed_launches(native, python), warm_native + warm_python


def chaos_era_inputs(seed: int):
    """The N=16 chaos eras' keys, proposals and parent -> (pub, privs,
    proposals, signer, parent)."""
    from lachain_tpu_torch.consensus.keys import trusted_key_gen

    pub, privs = trusted_key_gen(HB_CHECK_N, HB_CHECK_F, SeededRng(seed + 170))
    rng = random.Random(seed + 171)
    proposals, signer = root_transfers(HB_CHECK_N, ROOT_CHECK_TXS, rng)
    return pub, privs, proposals, signer, rng.randbytes(32)


def run_chaos_check_path(seed: int, dev):
    """The N=16, f=5 root era (TAKE_FIRST, both batchers, ROOT_CHECK_TXS
    transfers a validator) on the Python engine under the full fault plan:
    10% drops, 5% duplicates, 5% delays, 5% reorders, router 3 down over
    CHAOS_CRASH and {0,1,2,3} | {12,...,15} split over CHAOS_PARTITION;
    once on the card and once with device="cpu" (the era on the host
    pipeline, the block's senders on the plain kernels), each recovering
    its senders afresh: every router, router 3 included, makes the same
    block; every fault fired; outbox replay recovered the era; card and
    CPU equal in blocks, messages, fault tally, recovery rounds, flushes
    and evidence (none)."""
    from lachain_tpu_torch.consensus.simulator import DeliveryMode, SimulatedNetwork
    from lachain_tpu_torch.network.faults import Crash, FaultPlan, Partition

    label = f"chaos era check N={HB_CHECK_N}"
    n, f = HB_CHECK_N, HB_CHECK_F
    pub, privs, proposals, signer, parent = chaos_era_inputs(seed)
    plan = FaultPlan(seed=7, drop=0.10, duplicate=0.05, delay=0.05, reorder=0.05,
                     crashes=(Crash(3, *CHAOS_CRASH),),
                     partitions=(Partition(frozenset(range(4)), frozenset(range(12, 16)),
                                           *CHAOS_PARTITION),))
    outcomes, launches = [], None
    for device in (dev, "cpu"):
        clear_block_memos()
        reset_counts()
        factories, producers = root_factories(pub, privs, proposals, device, parent)
        net = SimulatedNetwork(pub, privs, seed=seed, mode=DeliveryMode.TAKE_FIRST,
                               use_rbc_batcher=True, device=device,
                               backend=check_backend(device), extra_factories=factories,
                               fault_plan=plan)
        wall, blocks = root_run(net, list(range(n)))
        if launches is None:
            launches, card_wall = read_launches(), wall
            check_no_escapes(label)
        check_root_blocks(f"{label} on {device}", net, blocks, list(range(n)), proposals,
                          signer, pub, n, f)
        stats = dict(net.faults.stats)
        check(all(stats[k] > 0 for k in ("dropped", "duplicated", "delayed", "reordered",
                                         "blocked")),
              f"{label} on {device}: a fault never fired: {stats}")
        check(net.recovery_rounds > 0, f"{label} on {device}: no recovery round")
        evidence = [net.routers[i].evidence.snapshot() for i in range(n)]
        check(not any(evidence), f"{label} on {device}: evidence {evidence}")
        outcomes.append(([b.encode() for b in blocks], net.delivered_count, stats,
                         net.recovery_rounds, net.crypto_batcher.flushes,
                         net.rbc_batcher.flushes, evidence))
        log(f"{label} on {device}: block of {len(blocks[0].tx_hashes)} transfers at all "
            f"{n} routers, wall {wall:.3f} s, {net.delivered_count} messages, "
            f"{net.recovery_rounds} recovery rounds, faults {stats}; block recovery "
            f"{root_seconds(net, producers)['recover_s']:.3f} s")
        batcher_lines(f"{label} on {device}", net)
    check(outcomes[0] == outcomes[1], f"{label}: the card's era differs from the CPU's")
    log(f"{label}: the card's era equals the CPU's (blocks, messages, faults, recovery "
        f"rounds, flushes, evidence)")
    return launches, [{"wall_s": card_wall}]


def run_chaos_native_check_path(seed: int, dev):
    """The N=16 chaos era's keys and proposals through the native engine
    under what it can express, FaultPlan(seed=3, duplicate=0.05,
    reorder=0.5, crashes=(Crash(15, 0),)) (TAKE_RANDOM, router 15 muted,
    the engine seeded with seed ^ 6), with validators 1 and 2 spamming
    2,600 junk coin slots each (3 faulty validators, within f = 5); once
    on the card and once with device="cpu" (as run_chaos_check_path):
    every live router makes one block, no evidence, card and CPU equal in
    blocks, messages and evidence; a plan with drops is refused by
    name."""
    from lachain_tpu_torch.consensus import adversary
    from lachain_tpu_torch.consensus.native_rt import NativeSimulatedNetwork
    from lachain_tpu_torch.consensus.simulator import DeliveryMode
    from lachain_tpu_torch.network.faults import Crash, FaultPlan

    label = f"chaos native era check N={HB_CHECK_N}"
    n, f = HB_CHECK_N, HB_CHECK_F
    pub, privs, proposals, signer, parent = chaos_era_inputs(seed)
    plan = FaultPlan(seed=3, duplicate=0.05, reorder=0.5, crashes=(Crash(15, 0),))
    spam = adversary.AdversaryPlan("spam", traitors=(1, 2), seed=seed)
    live = list(range(n - 1))
    honest = [i for i in live if i not in spam.traitors]
    outcomes, launches = [], None
    for device in (dev, "cpu"):
        clear_block_memos()
        reset_counts()
        net, producers = native_root_net(pub, privs, proposals, device, parent, seed,
                                         DeliveryMode.TAKE_FIRST,
                                         backend=check_backend(device), fault_plan=plan)
        check(net.mode is DeliveryMode.TAKE_RANDOM and net.muted == {15},
              f"{label}: the plan mapped to {net.mode}, muted {net.muted}")
        adversary.install(spam, net)
        wall, blocks = root_run(net, live)
        if launches is None:
            launches, card_wall = read_launches(), wall
            check_no_escapes(label)
        check_root_blocks(f"{label} on {device}", net, blocks, live, proposals, signer,
                          pub, n, f)
        evidence = [net.routers[i].evidence.snapshot() for i in honest]
        check(not any(evidence), f"{label} on {device}: evidence {evidence}")
        outcomes.append(([b.encode() for b in blocks], net.delivered_count, evidence))
        log(f"{label} on {device}: block of {len(blocks[0].tx_hashes)} transfers at the "
            f"{len(live)} live routers ({len(honest)} honest), wall {wall:.3f} s, "
            f"{net.delivered_count} messages, {net.native_handled()} handled natively; "
            f"crossings {net.crossings}; block recovery "
            f"{root_seconds(net, producers)['recover_s']:.3f} s")
        batcher_lines(f"{label} on {device}", net)
        net.close()
    check(outcomes[0] == outcomes[1], f"{label}: the card's era differs from the CPU's")
    try:
        NativeSimulatedNetwork(pub, privs, device=dev, fault_plan=FaultPlan(drop=0.1))
        check(False, f"{label}: a plan with drops was not refused")
    except ValueError as exc:
        check("drop" in str(exc), f"{label}: the refusal does not name drop: {exc}")
    log(f"{label}: the card's era equals the CPU's (blocks, messages, evidence); a plan "
        f"with drops is refused")
    return launches, [{"wall_s": card_wall}]


class TimedWrites:
    """A KV store mixin that appends the seconds of each write_batch (a
    journal record's fsynced commit) to the list `times`."""

    def __init__(self, path: str, times: list):
        super().__init__(path)
        self.times = times

    def write_batch(self, puts, deletes=()) -> None:
        t0 = time.perf_counter()
        super().write_batch(puts, deletes)
        self.times.append(time.perf_counter() - t0)


class TimedSqliteKV(TimedWrites, SqliteKV):
    """SqliteKV with TimedWrites: one file a validator."""


class TimedLsmKV(TimedWrites, LsmKV):
    """LsmKV with TimedWrites: one directory a validator."""


def journal_slots(label: str, journal) -> dict:
    """{(era, send slot): wire bytes} of a journal; fails if a slot was
    journaled twice."""
    from lachain_tpu_torch.consensus.journal import send_slot
    from lachain_tpu_torch.network import wire

    out = {}
    for era, _seq, _target, data in journal.entries():
        key = (era, send_slot(wire.decode_payload(data)))
        check(key[1] is not None and key not in out, f"{label}: slot {key} journaled twice")
        out[key] = data
    return out


def journaled_native_net(pub, privs, proposals, device, parent, seed, kvs):
    """native_root_net's TAKE_FIRST era with a ConsensusJournal over each
    of `kvs` -> (net, journals)."""
    from lachain_tpu_torch.consensus.journal import ConsensusJournal
    from lachain_tpu_torch.consensus.simulator import DeliveryMode

    journals = [ConsensusJournal(kv) for kv in kvs]
    net, _producers = native_root_net(pub, privs, proposals, device, parent, seed,
                                      DeliveryMode.TAKE_FIRST, journals=journals)
    return net, journals


def rearm(net, journals) -> None:
    """The restart: every router re-armed from its journal (its sent
    latches and outbox) before its first request."""
    for router, journal in zip(net.routers, journals):
        for era, _seq, target, data in journal.entries():
            router.rearm_sent(era, target, data)


def crash_run(net, crash_at: int) -> float:
    """Every validator starts its RootProtocol; the network runs until
    `crash_at` messages are delivered, before any block -> wall seconds."""
    from lachain_tpu_torch.consensus import messages as M

    pid = M.RootProtocolId(era=0)
    t0 = time.perf_counter()
    for i in range(net.n):
        net.post_request(i, pid, None)
    net.run(lambda: net.delivered_count >= crash_at, max_messages=HB_MAX_MESSAGES)
    check(net.delivered_count >= crash_at
          and all(r.result_of(pid) is None for r in net.routers),
          f"the era ended before the crash at {crash_at} messages ({net.delivered_count})")
    return time.perf_counter() - t0


def kv_rows(kv) -> list:
    return list(kv.scan_prefix(b""))


def spread(xs) -> str:
    """min / median / max of a list of counts."""
    xs = sorted(xs)
    return f"min {xs[0]}, median {xs[len(xs) // 2]}, max {xs[-1]}"


def busy_line(label: str, by_kernel: dict, wall: float) -> None:
    """Log a traced run's device time by kernel and its busy share of the
    wall."""
    busy = sum(v[0] for v in by_kernel.values())
    log(f"{label} by kernel (torch.profiler, ms, launches): {by_kernel}; busy "
        f"{busy:.3f} ms of the {wall * 1e3:.1f} ms wall: busy share {busy / (wall * 1e3):.6f}")


def summed_launches(*runs) -> dict:
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def run_root_journal_native_path(seed: int, dev, ref):
    """Crash recovery on the native engine at full width: root_era_native_64's
    era (keys, proposals, parent, seed; TAKE_FIRST, both batchers, Root
    native at every validator) with a ConsensusJournal a validator.
    Run A, journaled on MemoryKV and traced whole: root_era_64's block and
    delivered_count (`ref`: journaling adds no draw), every router's
    journal with "coin", "dec" and "hdr" records and no slot twice. Then
    twice, once on SqliteKV (one file a validator, TimedSqliteKV) and once
    on LsmKV (one engine directory a validator, TimedLsmKV), in a temporary
    directory: run B, stopped at CRASH_AT messages, then the network and
    every store closed (the crash); on LsmKV every crashed store then
    passes fsck(kv) with no fatal issue, and after the restart every
    store is clean under it. The restart, traced whole: the
    stores reopened (copies, so that a re-trace restarts from the same
    state) under fresh journals and a fresh network of the same seed,
    every router re-armed from its journal before its first request, run
    to the block: run A's block at all 64 routers and its messages, sends
    replayed from the journals (replayed_sends > 0, no more at a router
    than run B journaled), every store's rows equal to run A's journal (so
    each slot once, its bytes, the sequences continued), each journal
    recording exactly what run B had not. Then at router 0 every journaled
    coin and decryption share, re-derived with zeroed bytes through
    _native_send, comes back as the recorded bytes. Every run: no host
    recompute, traced launches equal to the counted ones."""
    import os
    import shutil
    import tempfile

    from lachain_tpu_torch.consensus import messages as M
    from lachain_tpu_torch.network import wire
    from lachain_tpu_torch.storage.fsck import fsck
    from lachain_tpu_torch.storage.kv import MemoryKV

    label = f"journal native root era N={HB_N}"
    pub, privs, proposals, signer, parent = root_era_inputs(seed)
    out = {}

    def run_a():
        clear_block_memos()
        reset_counts()
        kvs = [MemoryKV() for _ in range(HB_N)]
        net, journals = journaled_native_net(pub, privs, proposals, dev, parent, seed, kvs)
        out["wall"], out["blocks"] = root_run(net, range(HB_N))
        out["launches"] = read_launches()
        out.update(net=net, kvs=kvs, journals=journals)

    by_a, counted = trace_era(f"{label} run A", run_a, out, dev)
    a = dict(out)
    net, blocks = a["net"], a["blocks"]
    check_no_escapes(f"{label} run A")
    check_root_blocks(f"{label} run A", net, blocks, list(range(HB_N)), proposals, signer,
                      pub, HB_N, HB_F)
    check_native_crossings(f"{label} run A", net, HB_N)
    check_traced(f"{label} run A", by_a, a["launches"], counted)
    h = blocks[0].header.hash()
    check(h == ref["hash"] and net.delivered_count == ref["delivered"],
          f"{label} run A: block {h.hex()[:16]} / {net.delivered_count} messages, "
          f"root_era_64's {ref['hash'].hex()[:16]} / {ref['delivered']}")
    a_slots = [journal_slots(f"{label} run A", j) for j in a["journals"]]
    kinds = [{slot[0] for _era, slot in m} for m in a_slots]
    check(all(k >= {"coin", "dec", "hdr"} for k in kinds),
          f"{label} run A: a journal lacks coin, dec or hdr records: {kinds}")
    a_rows = [kv_rows(kv) for kv in a["kvs"]]
    a_delivered = net.delivered_count
    net.close()
    log(f"{label} run A: root_era_64's block {h.hex()[:16]} and {a_delivered} messages; "
        f"wall {a['wall']:.3f} s ({a_delivered / a['wall']:.0f} messages a second); journal "
        f"records a router {spread([len(r) for r in a_rows])}, "
        f"{sum(len(k) + len(v) for rows in a_rows for k, v in rows)} bytes in all, kinds "
        f"{sorted(set().union(*kinds))}")
    batcher_lines(f"{label} run A", net)
    busy_line(f"{label} run A", by_a, a["wall"])
    launches, walls = [a["launches"]], [dict(wall_s=a["wall"])]

    times = []
    legs = {}  # the engine's name -> its write_batch seconds and records
    with tempfile.TemporaryDirectory(prefix="lachain_journal_") as tmp:
        def fresh_dir() -> str:
            d = os.path.join(tmp, str(len(os.listdir(tmp))))
            os.mkdir(d)
            return d

        for engine, store in (("SqliteKV", TimedSqliteKV), ("LsmKV", TimedLsmKV)):
            def stores(d):
                return [store(os.path.join(d, str(i)), times) for i in range(HB_N)]

            def run_b():
                clear_block_memos()
                reset_counts()
                times.clear()
                d = fresh_dir()
                kvs = stores(d)
                net, journals = journaled_native_net(pub, privs, proposals, dev, parent, seed,
                                                     kvs)
                out["wall"] = crash_run(net, CRASH_AT)
                out["launches"] = read_launches()
                # the crash: the network and every store closed mid-era
                net.close()
                for kv in kvs:
                    kv.close()
                out.update(dir=d, delivered=net.delivered_count, times=list(times),
                           records=[j.records for j in journals],
                           flushes=(net.crypto_batcher.flushes, net.rbc_batcher.flushes))

            lab = f"{label} on {engine}"
            by_b, counted = trace_era(f"{lab} run B", run_b, out, dev)
            b = dict(out)
            check_no_escapes(f"{lab} run B")
            check_traced(f"{lab} run B", by_b, b["launches"], counted)
            check(sum(b["records"]) > 0, f"{lab} run B: nothing journaled before the crash")
            log(f"{lab} run B: crashed at {b['delivered']} messages (CRASH_AT {CRASH_AT}) "
                f"after {b['wall']:.3f} s ({b['delivered'] / b['wall']:.0f} a second); journal "
                f"records a router {spread(b['records'])}; {engine} write_batch "
                f"{sum(b['times']):.3f} s over {len(b['times'])} records, median "
                f"{sorted(b['times'])[len(b['times']) // 2] * 1e3:.3f} ms; flushes (tpke, rbc) "
                f"{b['flushes']}")
            busy_line(f"{lab} run B", by_b, b["wall"])
            if engine == "LsmKV":
                # what a node does on open: fsck every crashed store
                t0 = time.perf_counter()
                for kv in stores(b["dir"]):
                    report = fsck(kv)
                    check(not report.fatal, f"{lab}: fsck after the crash: {report.to_dict()}")
                    kv.close()
                log(f"{lab}: fsck of the {HB_N} crashed stores: no fatal issue "
                    f"({time.perf_counter() - t0:.3f} s)")

            def restart():
                clear_block_memos()
                reset_counts()
                times.clear()
                d = fresh_dir()
                for name in os.listdir(b["dir"]):
                    src = os.path.join(b["dir"], name)
                    (shutil.copytree if os.path.isdir(src) else shutil.copy)(
                        src, os.path.join(d, name))
                kvs = stores(d)
                net, journals = journaled_native_net(pub, privs, proposals, dev, parent, seed,
                                                     kvs)
                t0 = time.perf_counter()
                rearm(net, journals)
                out["rearm_s"] = time.perf_counter() - t0
                out["wall"], out["blocks"] = root_run(net, range(HB_N))
                out["launches"] = read_launches()
                out.update(net=net, kvs=kvs, journals=journals, times=list(times))

            by_r, counted = trace_era(f"{lab} restart", restart, out, dev)
            r = dict(out)
            net, blocks = r["net"], r["blocks"]
            check_no_escapes(f"{lab} restart")
            check_root_blocks(f"{lab} restart", net, blocks, list(range(HB_N)), proposals,
                              signer, pub, HB_N, HB_F)
            check_native_crossings(f"{lab} restart", net, HB_N)
            check_traced(f"{lab} restart", by_r, r["launches"], counted)
            check(blocks[0].header.hash() == h and net.delivered_count == a_delivered,
                  f"{lab} restart: block {blocks[0].header.hash().hex()[:16]} / "
                  f"{net.delivered_count} messages, run A's {h.hex()[:16]} / {a_delivered}")
            replayed = [router.replayed_sends for router in net.routers]
            check(sum(replayed) > 0 and all(x <= y for x, y in zip(replayed, b["records"])),
                  f"{lab} restart: replayed sends {replayed}, run B journaled {b['records']}")
            for i, (kv, journal) in enumerate(zip(r["kvs"], r["journals"])):
                check(journal_slots(f"{lab} restart", journal) == a_slots[i]
                      and kv_rows(kv) == a_rows[i],
                      f"{lab} restart: router {i}'s journal differs from run A's")
                check(journal.records == len(a_rows[i]) - b["records"][i],
                      f"{lab} restart: router {i} journaled {journal.records} records, "
                      f"run A {len(a_rows[i])}, run B {b['records'][i]}")
            # re-derivation at router 0: fresh payloads for its journaled coin and
            # decryption-share slots, with zeroed bytes, come back as recorded
            r0, checked = net.routers[0], 0
            records = r0._journal.records
            for (_era, slot), data in a_slots[0].items():
                stale = wire.decode_payload(data)
                if slot[0] == "coin":
                    fresh = M.CoinMessage(coin=stale.coin, share=bytes(len(stale.share)))
                elif slot[0] == "dec":
                    fresh = M.DecryptedMessage(hb=stale.hb, share_id=stale.share_id,
                                               payload=bytes(len(stale.payload)))
                else:
                    continue
                check(wire.encode_payload(r0._native_send(fresh)) == data,
                      f"{lab}: router 0 re-sent other bytes for {slot[0]} {slot[1:]}")
                checked += 1
            check(checked > 0 and r0._journal.records == records,
                  f"{lab}: the re-derivation checked nothing or journaled again")
            net.close()
            if engine == "LsmKV":
                for kv in r["kvs"]:
                    report = fsck(kv)
                    check(report.clean, f"{lab}: fsck after the restart: {report.to_dict()}")
            for kv in r["kvs"]:
                kv.close()
            legs[engine] = (sum(b["times"]) + sum(r["times"]), len(b["times"]) + len(r["times"]))
            log(f"{lab} restart: run A's block at all {HB_N} routers, {net.delivered_count} "
                f"messages; rearm {r['rearm_s']:.3f} s, wall {r['wall']:.3f} s "
                f"({net.delivered_count / r['wall']:.0f} messages a second); replayed sends "
                f"{sum(replayed)} ({spread(replayed)} a router); new journal records "
                f"{spread([j.records for j in r['journals']])} a router; {engine} write_batch "
                f"{sum(r['times']):.3f} s over {len(r['times'])} records, median "
                f"{sorted(r['times'])[len(r['times']) // 2] * 1e3:.3f} ms; every store equals "
                f"run A's journal{'; every store clean under fsck' if engine == 'LsmKV' else ''}; "
                f"router 0 re-sent {checked} re-derived shares as recorded")
            batcher_lines(f"{lab} restart", net)
            busy_line(f"{lab} restart", by_r, r["wall"])
            launches.append(b["launches"])
            launches.append(r["launches"])
            walls.append(dict(wall_s=r["wall"]))
    for engine, (fsync_s, n_records) in legs.items():
        log(f"{label}: the era's journal on {engine} (runs B and restart): {fsync_s:.3f} s of "
            f"write_batch over {n_records} records, a validator's {fsync_s / HB_N:.3f} s = "
            f"{fsync_s / HB_N / a['wall']:.4f} of run A's wall")
    return summed_launches(*launches), walls


def root_journal_inputs(seed: int):
    """The N=16 journal era's keys, proposals (BLOCK_TXS / HB_N signed
    transfers a validator, as at N=64) and parent -> (pub, privs,
    proposals, signer, parent)."""
    from lachain_tpu_torch.consensus.keys import trusted_key_gen

    pub, privs = trusted_key_gen(HB_CHECK_N, HB_CHECK_F, SeededRng(seed + 1640))
    rng = random.Random(seed + 1641)
    proposals, signer = root_transfers(HB_CHECK_N, -(-BLOCK_TXS // HB_N), rng)
    return pub, privs, proposals, signer, rng.randbytes(32)


def run_root_journal_path(seed: int, dev):
    """Crash recovery on the Python engine at N=16, f=5 (TAKE_FIRST, both
    batchers) with a ConsensusJournal on MemoryKV a validator through the
    routers' factory, where every protocol's sends are journaled. Run A,
    uncrashed on stores of its own: the block and delivered_count the
    restart must equal. Run B stopped at half of run A's messages, then
    restarted on a fresh network of the same seed over the same stores,
    every router re-armed from its journal before its first request, run
    to the block: run A's block and messages, each slot journaled once,
    every latchable kind journaled, sends replayed from the journals, no
    host recompute. Each run is traced whole; printed: walls, records a
    router, replayed sends, busy shares. (The N=64 journal semantics run
    at full width in root_era_journal_native_64.)"""
    import torch

    from lachain_tpu_torch.consensus.era import EraRouter
    from lachain_tpu_torch.consensus.journal import ConsensusJournal
    from lachain_tpu_torch.consensus.simulator import DeliveryMode, SimulatedNetwork
    from lachain_tpu_torch.storage.kv import MemoryKV

    n, f = HB_CHECK_N, HB_CHECK_F
    label = f"journal root era N={n}"
    pub, privs, proposals, signer, parent = root_journal_inputs(seed)
    kvs = [MemoryKV() for _ in range(n)]
    out = {}

    def journaled_net(stores):
        journals = [ConsensusJournal(kv) for kv in stores]
        factories, _producers = root_factories(pub, privs, proposals, dev, parent)
        net = SimulatedNetwork(
            pub, privs, seed=seed, mode=DeliveryMode.TAKE_FIRST, use_rbc_batcher=True,
            device=dev, extra_factories=factories,
            router_cls=lambda **kw: EraRouter(journal=journals[kw["my_id"]], **kw))
        return net, journals

    def run_a():
        clear_block_memos()
        reset_counts()
        net, _journals = journaled_net([MemoryKV() for _ in range(n)])
        out["wall_a"], blocks = root_run(net, range(n))
        out["launches_a"] = read_launches()
        check_root_blocks(f"{label} run A", net, blocks, list(range(n)), proposals, signer,
                          pub, n, f)
        out.update(hash_a=blocks[0].header.hash(), delivered_a=net.delivered_count)

    def crash():
        clear_block_memos()
        reset_counts()
        net, journals = journaled_net(kvs)
        out["crash_at"] = out["delivered_a"] // 2
        out["wall_b"] = crash_run(net, out["crash_at"])
        out["launches_b"] = read_launches()
        out.update(delivered_b=net.delivered_count, records_b=[j.records for j in journals])

    def restart():
        clear_block_memos()
        reset_counts()
        net, journals = journaled_net(kvs)
        rearm(net, journals)
        out["wall"], out["blocks"] = root_run(net, range(n))
        out["launches"] = read_launches()
        out.update(net=net, journals=journals)

    def warm():
        torch.arange(1 << 12, device=dev).sum().item()

    by_a = profile_device(run_a, warm=warm)
    check_no_escapes(f"{label} run A")
    by_b = profile_device(crash, warm=warm)
    check_no_escapes(f"{label} crash")
    by_r = profile_device(restart, warm=warm)
    check_no_escapes(f"{label} restart")
    net, blocks = out["net"], out["blocks"]
    check_root_blocks(label, net, blocks, list(range(n)), proposals, signer, pub, n, f)
    h = blocks[0].header.hash()
    check(h == out["hash_a"] and net.delivered_count == out["delivered_a"],
          f"{label}: block {h.hex()[:16]} / {net.delivered_count} messages, run A's "
          f"{out['hash_a'].hex()[:16]} / {out['delivered_a']}")
    slots = [journal_slots(label, j) for j in out["journals"]]
    kinds = [{slot[0] for _era, slot in m} for m in slots]
    check(all(k == LATCHED_KINDS for k in kinds),
          f"{label}: journals miss kinds: {[sorted(LATCHED_KINDS - k) for k in kinds]}")
    replayed = [router.replayed_sends for router in net.routers]
    check(sum(replayed) > 0 and all(x <= y for x, y in zip(replayed, out["records_b"])),
          f"{label}: replayed sends {replayed}, journaled before the crash "
          f"{out['records_b']}")
    log(f"{label}: run A's block {out['hash_a'].hex()[:16]} and {out['delivered_a']} "
        f"messages in {out['wall_a']:.3f} s; crashed at {out['delivered_b']} messages (half "
        f"of run A's, {out['crash_at']}) after {out['wall_b']:.3f} s, restarted: run A's "
        f"block at all {n} routers and its {net.delivered_count} messages in "
        f"{out['wall']:.3f} s; journal records a router {spread([len(m) for m in slots])} "
        f"({sum(len(m) for m in slots)} in all), before the crash {spread(out['records_b'])}; "
        f"replayed sends {sum(replayed)} ({spread(replayed)} a router)")
    batcher_lines(f"{label} restart", net)
    busy_line(f"{label} run A", by_a, out["wall_a"])
    busy_line(f"{label} crash", by_b, out["wall_b"])
    busy_line(f"{label} restart", by_r, out["wall"])
    return (summed_launches(out["launches_a"], out["launches_b"], out["launches"]),
            [dict(wall_s=out["wall"])])


# the DKG phase: one validator's whole keygen at N=16, f=5 (cut from
# BASELINE config 4's N=64, f=21, whose keygen now runs at full width
# inside rotation_64); dealer by dealer, its state snapshotted and resumed
# after dealer DKG_RESUME's round; senders DKG_N - 2 and DKG_N - 1
# byzantine (random bytes, and the true value + 1); DKG_TRACED's value
# round traced by kernel
DKG_N, DKG_F = 16, 5
DKG_RESUME = 7
DKG_TRACED = 10
# an ECIES ciphertext: ephemeral key (33) + nonce (12) + plaintext + tag (16)
ECIES_OVERHEAD = 33 + 12 + 16


class Tally:
    """Summed seconds and calls of wrapped functions, by key."""

    def __init__(self):
        self.s: dict = {}
        self.n: dict = {}

    def wrap(self, key: str, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.s[key] = self.s.get(key, 0.0) + time.perf_counter() - t0
                self.n[key] = self.n.get(key, 0) + 1
        return timed

    def line(self) -> str:
        return ", ".join(f"{k} {self.s[k]:.3f} s ({self.n[k]} calls)" for k in sorted(self.s))


def dkg_launches(n: int, f: int, commits: int, values: int) -> dict:
    """G1 launches of the DKG's card MSMs: a row check is one batch of f+1
    groups padded to k = 2^ceil(log2(f+1)) lanes, a value check one MSM
    over the distinct coefficients its (f+1)^2 terms reach (143 at f = 21)
    padded to a power of two, the keyring f+1 row batches at 0 and one
    batch of n+1 groups of k; each one table build, one scan, log2(k) tree
    adds and 2 g1_mont (the pack, the fetch)."""
    from lachain_tpu_torch.consensus.keygen import _tri_index

    k_row = 1 << f.bit_length()  # the least power of two >= f + 1
    distinct = len({_tri_index(i, j) for i in range(f + 1) for j in range(f + 1)})
    k_val = 1 << (distinct - 1).bit_length()
    rows = commits + f + 2
    calls = rows + values
    adds = rows * (k_row.bit_length() - 1) + values * (k_val.bit_length() - 1)
    return {"g1_table": calls, "g1_msm_scan": calls, "g1_add": adds, "g1_mont": 2 * calls,
            "g1_dbl": 0, "fp_mul": 0}


def run_dkg_path(seed: int, dev):
    """One validator's whole DKG at N = DKG_N, f = DKG_F
    (consensus/keygen.py; 16 and 5, the N=64 keygen runs in rotation_64),
    its MSMs on the card through the normal entry points: validator 0 is a
    TrustlessKeygen on one_card_backend(dev) with a seeded rng; the other
    N - 1 dealers are the harness's. This is the cut: each draws a
    BiVarSymmetricPolynomial (their commitments made on the host in one
    g1_mul_batch) and sends validator 0 a real ECIES row, its other rows
    seeded filler of the real length (33 + 12 + (f + 1) * 32 + 16 bytes;
    validator 0 never opens them); each sender s >= 1 sends, per dealer d,
    a ValueMessage whose entry for validator 0 is a real ECIES F_d(s+1, 1)
    and whose other entries are 93-byte fillers. In the chain's order,
    dealer by dealer: validator 0's handle_commit (its own real
    ValueMessage of N values), then the values of senders 0..N-1 (sender
    0's its own). Sender N-2's entry is random bytes, sender N-1's
    F_d(N, 1) + 1: both acked, neither valid. After dealer DKG_RESUME's
    round the state is snapshotted (to_bytes), resumed (from_bytes, ==)
    and the resumed object runs on. Then try_get_keys and N - f
    confirmations. Checks: every dealer finished in order;
    handle_send_value True once, at dealer f's (2f+1)-th sender; the
    confirm at the (N-f)-th vote; the keyring equal to what the first f+1
    dealers' polynomials give (x_0, and g1 * sum_d F_d(0, j) for j = 0..N
    against the TPKE key, the verification keys and the TS keys); a TS
    signature combined from f+1 shares (validator 0's and f the harness
    derives) verifying under the keyring's set; a TPKE ciphertext
    decrypted from f+1 shares, each verified; exactly the counted G1
    launches (dkg_launches); no host recompute. Printed: the walls, the
    summed seconds of ECIES, host g1_mul and the card's MSM calls, and
    dealer DKG_TRACED's value round traced by kernel with its busy
    share."""
    from lachain_tpu_torch.consensus import keygen as kg
    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.crypto import threshold_sig as ts
    from lachain_tpu_torch.crypto import tpke

    import torch

    n, f = DKG_N, DKG_F
    label = f"dkg N={n}"
    bad_bytes, bad_value = n - 2, n - 1
    walls = {}
    t0 = time.perf_counter()
    rng = SeededRng(seed * 1_000_003 + 64)
    privs = [ecdsa.generate_private_key(rng) for _ in range(n)]
    pubs = [ecdsa.public_key_bytes(p) for p in privs]
    backend = one_card_backend(dev)
    host = backend.host
    enc, dec = ecdsa.ecies_encrypt, ecdsa.ecies_decrypt
    filler = random.Random(seed * 1_000_003 + 65)
    row_len = ECIES_OVERHEAD + (f + 1) * bls.FR_BYTES
    val_len = ECIES_OVERHEAD + bls.FR_BYTES
    # the harness's dealers 1..n-1: polynomials, commitments in one call
    polys = [None] + [kg.BiVarSymmetricPolynomial.random(f, SeededRng(seed * 1_000_003 + d))
                      for d in range(1, n)]
    m = len(polys[1].coeffs)
    flat = host.g1_mul_batch([bls.G1_GEN] * (m * (n - 1)),
                             [c for p in polys[1:] for c in p.coeffs])
    commits = [None] + [
        kg.CommitMessage(kg.Commitment(flat[(d - 1) * m:d * m]),
                         [enc(pubs[0], b"".join(bls.fr_to_bytes(c)
                                                for c in polys[d].evaluate_row(1)), rng)]
                         + [filler.randbytes(row_len) for _ in range(n - 1)])
        for d in range(1, n)]

    def values_for(d: int, at_one) -> list:
        """The harness senders' ValueMessages for dealer d: at_one[s] is
        F_d(s+1, 1)."""
        out = [None]
        for s in range(1, n):
            if s == bad_bytes:
                mine = filler.randbytes(val_len)
            else:
                v = (at_one[s] + (s == bad_value)) % bls.R
                mine = enc(pubs[0], bls.fr_to_bytes(v), rng)
            out.append(kg.ValueMessage(d, [mine] + [filler.randbytes(val_len)
                                                    for _ in range(n - 1)]))
        return out

    # F_d(s+1, 1) = F_d(1, s+1): the row at x = 1 evaluated at s + 1
    harness_values = [None] + [values_for(d, [bls.fr_eval_poly(polys[d].evaluate_row(1),
                                                                 s + 1) for s in range(n)])
                               for d in range(1, n)]
    walls["setup"] = time.perf_counter() - t0

    # validator 0's calls timed: its ECIES, host products and card MSMs
    tally = Tally()
    ecdsa.ecies_encrypt = tally.wrap("ecies_encrypt", enc)
    ecdsa.ecies_decrypt = tally.wrap("ecies_decrypt", dec)
    timed = [(backend, "g1_mul", "host g1_mul"), (host, "g1_mul_batch", "host g1_mul_batch"),
             (backend, "g1_msm", "card g1_msm"), (backend, "g1_msm_batch", "card g1_msm_batch")]
    for obj, name, key in timed:
        setattr(obj, name, tally.wrap(key, getattr(obj, name)))
    v0_seed = seed * 1_000_003 + 66
    try:
        reset_counts()
        v0 = kg.TrustlessKeygen(privs[0], pubs, f, 0, SeededRng(v0_seed), backend)
        t0 = time.perf_counter()
        commits[0] = v0.start_keygen()
        walls["start_keygen"] = time.perf_counter() - t0
        # the harness's senders open their rows of validator 0's commit, as
        # a chain's would; a replay of its seeded draw is its polynomial
        t0 = time.perf_counter()
        rows = [[bls.fr_from_bytes(raw[o:o + bls.FR_BYTES])
                 for o in range(0, len(raw), bls.FR_BYTES)]
                for raw in (dec(privs[s], commits[0].encrypted_rows[s]) for s in range(n))]
        polys[0] = kg.BiVarSymmetricPolynomial.random(f, SeededRng(v0_seed))
        check(rows == [polys[0].evaluate_row(s + 1) for s in range(n)],
              f"{label}: validator 0's rows are not its seeded polynomial's")
        harness_values[0] = values_for(0, [bls.fr_eval_poly(r, 1) for r in rows])
        walls["setup"] += time.perf_counter() - t0

        fired = []
        walls.update(commits=0.0, values=0.0)
        traced = {}

        def value_round(d, own):
            t = time.perf_counter()
            for s in range(n):
                if v0.handle_send_value(s, own if s == 0 else harness_values[d][s]):
                    fired.append((d, s))
            traced["wall"] = time.perf_counter() - t
            walls["values"] += traced["wall"]

        def warm():
            torch.arange(1 << 12, device=dev).sum().item()

        for d in range(n):
            t = time.perf_counter()
            own = v0.handle_commit(d, commits[d])
            walls["commits"] += time.perf_counter() - t
            check(len(own.encrypted_values) == n, f"{label}: dealer {d}: a short ValueMessage")
            if d == DKG_TRACED:
                before = read_launches()
                traced["by_kernel"] = profile_device(lambda: value_round(d, own), warm=warm)
                traced["counted"] = {k: read_launches()[k] - before[k] for k in before}
            else:
                value_round(d, own)
            if d == DKG_RESUME:
                t = time.perf_counter()
                snapshot = v0.to_bytes()
                resumed = kg.TrustlessKeygen.from_bytes(snapshot, privs[0],
                                                        SeededRng(v0_seed + 1), backend)
                check(resumed == v0 and resumed.to_bytes() == snapshot,
                      f"{label}: the resumed state differs from the snapshot's")
                walls["resume"] = time.perf_counter() - t
                walls["snapshot_bytes"] = len(snapshot)
                v0 = resumed
        t = time.perf_counter()
        ring = v0.try_get_keys()
        walls["try_get_keys"] = time.perf_counter() - t
        check(ring is not None, f"{label}: no keyring")
        votes = [v0.handle_confirm(ring.public_key_hash) for _ in range(n - f)]
        launches = read_launches()
        check_no_escapes(label)
    finally:
        ecdsa.ecies_encrypt, ecdsa.ecies_decrypt = enc, dec
        for obj, name, _key in timed:
            delattr(obj, name)  # the class's method again

    check(v0.finished_dealers == list(range(n)),
          f"{label}: finished dealers {v0.finished_dealers}")
    check(fired == [(f, 2 * f)], f"{label}: confirm ready at {fired}, not at dealer {f}'s "
          f"sender {2 * f}")
    check(votes == [False] * (n - f - 1) + [True], f"{label}: the confirm fired at {votes}")
    st = v0.states[0]
    check(st.acks == [True] * n and st.valid == [True] * (n - 2) + [False, False],
          f"{label}: dealer 0's acks / valid {st.acks} / {st.valid}")
    # every value but sender 62's (undecryptable) reaches its MSM
    want = dkg_launches(n, f, n, n * (n - 1))
    check({k: launches[k] for k in want} == want,
          f"{label}: launches {launches}, want {want}")
    # the keyring against the first f+1 dealers' polynomials
    t0 = time.perf_counter()
    at_zero = [polys[d].evaluate_row(0) for d in range(f + 1)]
    shares = [sum(bls.fr_eval_poly(r, j) for r in at_zero) % bls.R for j in range(n + 1)]
    check(ring.tpke_priv.x_i == shares[1] == ring.ts_share.x_i and ring.tpke_priv.my_id == 0,
          f"{label}: x_0 differs from the polynomials'")
    keys = host.g1_mul_batch([bls.G1_GEN] * (n + 1), shares)
    check(bls.g1_eq(ring.tpke_pub.y, keys[0]) and ring.tpke_pub.t == f,
          f"{label}: the TPKE key differs from the polynomials'")
    check(all(bls.g1_eq(vk.y_i, y) for vk, y in zip(ring.tpke_verification_keys, keys[1:]))
          and all(bls.g1_eq(k.y, y) for k, y in zip(ring.ts_key_set.keys, keys[1:]))
          and len(ring.ts_key_set.keys) == n,
          f"{label}: the verification or TS keys differ from the polynomials'")
    msg = b"dkg %d coin" % seed
    sig_shares = [ring.ts_share.sign(msg, host)] + [
        ts.TsPrivateKeyShare(shares[i + 1], i).sign(msg, host) for i in range(1, f + 1)]
    key_set = ring.ts_key_set
    check(all(key_set.verify_share(msg, s, host) for s in sig_shares),
          f"{label}: a TS share does not verify")
    check(key_set.shared.verify(msg, key_set.combine(sig_shares, host), host),
          f"{label}: the combined TS signature does not verify")
    plain = bytes(range(32))
    ct = ring.tpke_pub.encrypt(plain, 5, rng, host)
    dshares = [ring.tpke_priv.decrypt_share(ct, backend=host)] + [
        tpke.TpkePrivateKey(shares[i + 1], i).decrypt_share(ct, backend=host)
        for i in range(1, f + 1)]
    vks = [ring.tpke_verification_keys[d.decryptor_id] for d in dshares]
    check(ring.tpke_pub.batch_verify_shares(vks, dshares, ct, rng, host) == [True] * (f + 1),
          f"{label}: a TPKE decryption share does not verify")
    check(ring.tpke_pub.full_decrypt(ct, dshares, host) == plain,
          f"{label}: the TPKE round trip failed")
    walls["checks"] = time.perf_counter() - t0
    wall = sum(walls[k] for k in ("setup", "start_keygen", "commits", "values", "resume",
                                  "try_get_keys"))
    log(f"{label}: every dealer finished, the confirm at dealer {f}'s sender {2 * f} and "
        f"vote {n - f}, the keyring equal to the first {f + 1} dealers' polynomials, TS "
        f"and TPKE round trips of {f + 1} shares, no host recompute; launches {want}")
    log(f"{label} walls: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items() if k != "snapshot_bytes")
        + f"; snapshot {walls['snapshot_bytes']} bytes; phase {wall:.3f} s")
    log(f"{label} summed: {tally.line()}")
    by_kernel = traced["by_kernel"]
    log(f"{label} dealer {DKG_TRACED}'s value round: counted launches "
        f"{ {k: v for k, v in traced['counted'].items() if v} }, traced "
        f"{ {k: by_kernel.get(KERNEL_OF[k], [0, 0])[1] for k in want if want[k]} }")
    busy_line(f"{label} dealer {DKG_TRACED}'s value round", by_kernel, traced["wall"])
    return launches, [dict(wall_s=wall)]


# ---------------------------------------------------------------------------
# the storage: one validator's state on LsmKV
# ---------------------------------------------------------------------------

# state_commit_1m: a genesis of a million accounts, then two blocks of
# 10,000 signed transfers each (BASELINE.json's "10k-tx blocks")
STATE_ACCOUNTS = 1_000_000
STATE_SENDERS = 1_024
STATE_BLOCKS = 2
STATE_TXS = 10_000
STATE_SAMPLES = 1_000  # balances read back after the reopen
STATE_RETAIN = 1  # DbShrink's retain_depth
TRANSFER_GAS = 21_000  # the base transfer's gas (lachain_tpu/core/execution.py:26)
BALANCE_ROW = b"b:"  # a balance's key in `balances` (lachain_tpu/core/execution.py:28)


def state_inputs(seed: int, accounts: int, senders: int, blocks: int, txs: int) -> dict:
    """A genesis and its transfer blocks: `senders` seeded keys' addresses,
    then keccak256(i)[:20] for the other accounts, each with a seeded
    32-byte balance; `blocks` lists of `txs` transfers on ROOT_CHAIN_ID,
    signed natively, transfer t by sender t % senders with nonce t //
    senders, to a seeded genesis account -> {"keys", "addrs" (the senders'),
    "accounts", "balances" {address: int}, "blocks" [[stx]], "sign_s"}."""
    from lachain_tpu_torch.core import types
    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.crypto.hashes import keccak256_batch

    rng = random.Random(seed + 2300)
    keys = [rng.randrange(1, ecdsa.N).to_bytes(32, "big") for _ in range(senders)]
    addrs = [ecdsa.address_from_public_key(ecdsa.public_key_bytes(k)) for k in keys]
    others = keccak256_batch([i.to_bytes(8, "big") for i in range(accounts - senders)])
    accts = addrs + [h[:20] for h in others]
    balances = {a: int.from_bytes(rng.randbytes(32), "big") for a in accts}
    check(len(balances) == accounts, "two genesis accounts share an address")
    t0 = time.perf_counter()
    out = []
    for b in range(blocks):
        batch = []
        for j in range(txs):
            t = b * txs + j
            tx = types.Transaction(to=accts[rng.randrange(accounts)],
                                   value=rng.randrange(1, 10**9), nonce=t // senders,
                                   gas_price=rng.randrange(1, 100), gas_limit=TRANSFER_GAS)
            batch.append(types.sign_transaction(tx, keys[t % senders], ROOT_CHAIN_ID))
        out.append(batch)
    return dict(keys=keys, addrs=addrs, accounts=accts, balances=balances, blocks=out,
                sign_s=time.perf_counter() - t0)


def genesis_writes(balances: dict) -> dict:
    """The genesis snapshot's writes: every account's balance row."""
    return {"balances": {BALANCE_ROW + a: v.to_bytes(32, "big") for a, v in balances.items()}}


def transfer_writes(balances: dict, stxs) -> dict:
    """The state rows a block of transfers writes, as execution would
    (item 13.2 ports it): `transactions` tx hash -> the signed transfer,
    `balances` the sender's (less value and fee) and the recipient's new
    balance; `balances` is updated in place. Every sender must be
    recovered already (its sender cache warm)."""
    touched = set()
    txs = {}
    for stx in stxs:
        sender = stx.sender(ROOT_CHAIN_ID)
        tx = stx.tx
        cost = tx.value + TRANSFER_GAS * tx.gas_price
        check(sender is not None and balances[sender] >= cost,
              "a transfer has no sender or overdraws its sender")
        balances[sender] -= cost
        balances[tx.to] += tx.value
        touched.update((sender, tx.to))
        txs[stx.hash()] = stx.encode()
    return {"transactions": txs,
            "balances": {BALANCE_ROW + a: balances[a].to_bytes(32, "big") for a in touched}}


def commit_block(state, kv, height: int, parent: bytes, stxs, writes: dict):
    """Snapshot `writes` over the committed state, commit it as `height`
    through state.freeze_and_commit (streamed over an engine with async
    batches when the writes reach its threshold), then write the block's
    rows as the reference's BlockManager._persist does (BLOCK_BY_HASH with
    Block.encode(), BLOCK_HASH_BY_HEIGHT; lachain_tpu/core/block_manager.py:
    208-225): after the commit here, since the header carries the state
    hash the commit computes -> (block, roots). `state` and `kv` may be
    either package's: the rows are the same bytes."""
    from lachain_tpu_torch.core import types
    from lachain_tpu_torch.storage.kv import EntryPrefix, prefixed
    from lachain_tpu_torch.utils.serialization import write_u64

    snap = state.new_snapshot()
    for tree, rows in writes.items():
        for k, v in rows.items():
            snap.put(tree, k, v)
    roots = state.freeze_and_commit(height, snap)
    hashes = [stx.hash() for stx in stxs]
    header = types.BlockHeader(index=height, prev_block_hash=parent,
                               merkle_root=types.tx_merkle_root(hashes) if hashes
                               else types.ZERO_HASH,
                               state_hash=roots.state_hash(), nonce=height)
    block = types.Block(header=header, tx_hashes=tuple(hashes), multisig=types.MultiSig(()))
    h = block.hash()
    kv.write_batch([(prefixed(EntryPrefix.BLOCK_BY_HASH, h), block.encode()),
                    (prefixed(EntryPrefix.BLOCK_HASH_BY_HEIGHT, write_u64(height)), h)])
    return block, roots


def dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def put_latency_us(path: str, n: int = 1_000) -> float:
    """The median microseconds of n single puts (one fsynced WAL record
    each) into a fresh LsmKV at `path`: what the disk charges a durable
    write."""
    from lachain_tpu_torch.storage.lsm import LsmKV

    kv = LsmKV(path)
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        kv.put(i.to_bytes(8, "big"), b"\x01")
        times.append(time.perf_counter() - t0)
    kv.close()
    return sorted(times)[n // 2] * 1e6


def peak_rss_mib() -> float:
    """This process's peak resident set so far (getrusage; Linux: KiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def trie_rows(kv) -> int:
    from lachain_tpu_torch.storage.kv import EntryPrefix, prefixed

    return sum(1 for _ in kv.scan_prefix(prefixed(EntryPrefix.TRIE_NODE)))


LSM_HISTOGRAMS = ("lsm_wal_fsync_seconds", "lsm_wal_group_commit_records")


def lsm_histograms() -> dict:
    """The LSM recorder's two histograms as they stand: {name: snapshot}."""
    from lachain_tpu_torch.utils import metrics

    return {n: metrics.histogram_snapshot(n) or {"count": 0, "sum": 0.0, "buckets": []}
            for n in LSM_HISTOGRAMS}


def lsm_line(label: str, what: str, before: dict) -> None:
    """Log what the drained LSM recorder fed the WAL's fsync-latency and
    group-commit histograms since `before` (lsm_histograms()): count, sum,
    mean and the cumulative buckets; check that the ring dropped nothing."""
    from lachain_tpu_torch.utils import metrics

    now = lsm_histograms()
    parts = []
    for name in LSM_HISTOGRAMS:
        a, b = before[name], now[name]
        n, total = b["count"] - a["count"], b["sum"] - a["sum"]
        old = dict(a["buckets"])
        cum = [(le, c - old.get(le, 0)) for le, c in b["buckets"]]
        check(n > 0, f"{label}: the LSM recorder fed no {name} sample over {what}")
        parts.append(f"{name} count {n} sum {total:.6f} mean {total / n:.6g} "
                     f"buckets (le, cumulative) {cum}")
    dropped = metrics.counter_value("trace_events_dropped_total", labels={"source": "lsm"})
    log(f"{label}: the LSM flight recorder over {what}: " + "; ".join(parts)
        + f"; trace_events_dropped_total{{source=lsm}} {dropped:.0f}")


def run_state_path(seed: int, dev, keep: dict):
    """One validator's state on LsmKV in a temporary directory, at full
    size: a genesis of STATE_ACCOUNTS accounts, then STATE_BLOCKS blocks of
    STATE_TXS signed transfers (state_inputs), each block's senders
    recovered on `dev` by core/types.warm_sender_caches (as BlockManager
    does before it executes) and held equal to the signing keys'
    addresses, its rows (transfer_writes, commit_block) committed through
    StateManager.freeze_and_commit (streamed) and a quick fsck after every
    commit, which must be clean. Then the last block's writes frozen again
    from the block before's roots with one merkle worker on a fresh
    StateManager and discarded: the sharded commit's roots. The store
    closed and reopened: committed_height, roots_at every height and
    STATE_SAMPLES sampled balances as written. DbShrink(retain_depth=
    STATE_RETAIN) sweeps the genesis-only nodes; a deep fsck over the
    retained snapshots is then clean. The recoveries' launches are counted
    (exactly recover_launches(STATE_TXS) a block on the card). First, the
    median latency of a single put in the same directory (put_latency_us).
    The temporary directory stays for block_exec_1m, which continues on
    its store: `keep` gets its path ("dir", "store"), the senders' keys and
    addresses, the accounts and the height's block; main removes it."""
    import os
    import tempfile

    import torch

    from lachain_tpu_torch.core import types
    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.storage import trie as trie_mod
    from lachain_tpu_torch.storage.fsck import fsck
    from lachain_tpu_torch.storage.lsm import LsmKV
    from lachain_tpu_torch.storage.shrink import DbShrink
    from lachain_tpu_torch.storage.state import StateManager
    from lachain_tpu_torch.utils import tracing

    label = f"state_commit N={STATE_ACCOUNTS}"
    t0 = time.perf_counter()
    inp = state_inputs(seed, STATE_ACCOUNTS, STATE_SENDERS, STATE_BLOCKS, STATE_TXS)
    balances = inp["balances"]
    log(f"{label} host setup ({STATE_SENDERS} keys, {STATE_ACCOUNTS} balances, "
        f"{STATE_BLOCKS} x {STATE_TXS} transfers signed natively in {inp['sign_s']:.1f} s): "
        f"{time.perf_counter() - t0:.1f} s")

    def clean(what: str, kv) -> float:
        t = time.perf_counter()
        report = fsck(kv, repair=False)
        check(report.clean, f"{label}: quick fsck after {what}: {report.to_dict()}")
        return time.perf_counter() - t

    def commit_line(what: str, state, kv, wall: float, fsck_s: float) -> None:
        log(f"{label} {what}: commit wall {wall:.3f} s, quick fsck {fsck_s:.3f} s clean; "
            f"commit_stats {state.commit_stats}; merkle_stats {state.trie.merkle_stats}; "
            f"LsmKV {kv.stats()}")

    warm, roots, blocks = [], [], []
    tmp = tempfile.mkdtemp(prefix="lachain_state_")
    keep["dir"] = tmp
    log(f"{label}: a single LsmKV put (one fsynced WAL record) in the temporary "
        f"directory: median {put_latency_us(os.path.join(tmp, 'probe')):.1f} us of 1,000")
    store = os.path.join(tmp, "state")
    lsm_before = lsm_histograms()
    kv = LsmKV(store)
    kv.trace_configure(TRACE_CAPACITY)
    state = StateManager(kv)
    t0 = time.perf_counter()
    writes = genesis_writes(balances)
    state.trie.reset_merkle_stats()
    block, r = commit_block(state, kv, 0, types.ZERO_HASH, [], writes)
    wall = time.perf_counter() - t0
    commit_line(f"genesis ({STATE_ACCOUNTS} balances)", state, kv, wall, clean("genesis", kv))
    tracing.drain_native()  # the LSM recorder's events, its histograms fed
    warm.append(dict(wal_fsync_s=state.commit_stats["wal_fsync_s"], wall_s=wall))
    roots.append(r)
    blocks.append(block)

    reset_counts()
    recover_ms = []
    for height, stxs in enumerate(inp["blocks"], start=1):
        types._SENDER_MEMO.clear()
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        types.warm_sender_caches(stxs, ROOT_CHAIN_ID, device=dev)
        rec_s = time.perf_counter() - t0
        recover_ms.append(rec_s * 1e3)
        senders = [stx.sender(ROOT_CHAIN_ID) for stx in stxs]
        want = [inp["addrs"][(t + (height - 1) * STATE_TXS) % STATE_SENDERS]
                for t in range(len(stxs))]
        check(senders == want, f"{label} block {height}: a recovered sender differs")
        log(f"{label} block {height}: {len(stxs)} senders recovered on {dev} in "
            f"{rec_s * 1e3:.3f} ms (wall), phases "
            f"{phase_line(ecdsa.batch_recoverer(dev).last_timings) if torch.device(dev).type == 'cuda' else 'cpu'}; "
            f"each equals its signing key's address")
        t0 = time.perf_counter()
        writes = transfer_writes(balances, stxs)
        state.trie.reset_merkle_stats()
        block, r = commit_block(state, kv, height, blocks[-1].hash(), stxs, writes)
        wall = time.perf_counter() - t0
        rows = sum(len(w) for w in writes.values())
        check(rows < state.stream_threshold or state.commit_stats["streamed_batches"] > 0,
              f"{label} block {height}: {rows} rows, the commit did not stream")
        check(rows < trie_mod.MIN_SHARD_OPS or (os.cpu_count() or 1) == 1
              or state.trie.merkle_stats["workers"] > 1,
              f"{label} block {height}: not sharded: {state.trie.merkle_stats}")
        commit_line(f"block {height} ({rows} rows)", state, kv, wall,
                    clean(f"block {height}", kv))
        tracing.drain_native()
        warm.append(dict(recover_s=rec_s, wal_fsync_s=state.commit_stats["wal_fsync_s"],
                         wall_s=wall))
        roots.append(r)
        blocks.append(block)
    launches = read_launches()
    check_no_escapes(label)
    if torch.device(dev).type == "cuda":
        want = {k: STATE_BLOCKS * v for k, v in recover_launches(STATE_TXS).items()}
        check(launches == want, f"{label}: launches {launches} != expected {want}")

    # the last block's writes again, serially, from the block before's roots
    t0 = time.perf_counter()
    serial = StateManager(kv)
    snap = serial.new_snapshot(serial.roots_at(STATE_BLOCKS - 1))
    for tree, rows in writes.items():
        for k, v in rows.items():
            snap.put(tree, k, v)
    again = snap.freeze(workers=1)
    snap.discard()
    check(again == roots[-1], f"{label}: the serial freeze's roots differ from the commit's")
    log(f"{label}: block {STATE_BLOCKS}'s writes frozen again serially "
        f"({serial.trie.merkle_stats}) in {time.perf_counter() - t0:.3f} s give the "
        f"sharded commit's roots")
    del serial

    kv.close()
    lsm_line(label, "the commits", lsm_before)
    t0 = time.perf_counter()
    kv = LsmKV(store)
    state = StateManager(kv)
    check(state.committed_height() == STATE_BLOCKS
          and [state.roots_at(h) for h in range(STATE_BLOCKS + 1)] == roots,
          f"{label}: the reopened store's height or roots differ")
    rng = random.Random(seed + 2301)
    snap = state.new_snapshot()
    for a in rng.sample(inp["accounts"], STATE_SAMPLES):
        check(snap.get("balances", BALANCE_ROW + a) == balances[a].to_bytes(32, "big"),
              f"{label}: balance of {a.hex()} read back wrong")
    log(f"{label}: reopened in {time.perf_counter() - t0:.3f} s: height "
        f"{STATE_BLOCKS}, the roots of every height and {STATE_SAMPLES} sampled "
        f"balances as written; LsmKV {kv.stats()}")

    before, disk = trie_rows(kv), dir_bytes(store)
    t0 = time.perf_counter()
    stats = DbShrink(state, kv).shrink(retain_depth=STATE_RETAIN)
    shrink_s = time.perf_counter() - t0
    after = trie_rows(kv)
    check(stats["swept"] > 0 and after == before - stats["swept"]
          and state.roots_at(0) is None and state.roots_at(STATE_BLOCKS) == roots[-1],
          f"{label}: shrink {stats}, trie nodes {before} -> {after}")
    t0 = time.perf_counter()
    report = fsck(kv, repair=False, deep=True)
    deep_s = time.perf_counter() - t0
    check(report.clean, f"{label}: deep fsck after shrink: {report.to_dict()}")
    kv.flush()
    log(f"{label}: shrink(retain_depth={STATE_RETAIN}) {stats} in {shrink_s:.3f} s, "
        f"trie nodes {before} -> {after}; deep fsck of heights "
        f"{STATE_BLOCKS - STATE_RETAIN}..{STATE_BLOCKS} clean in {deep_s:.3f} s (both by "
        f"prefix scans); bytes on disk {disk} before the shrink, {dir_bytes(store)} after; "
        f"the process's peak RSS {peak_rss_mib():.0f} MiB; LsmKV {kv.stats()}")
    kv.close()
    log(f"{label}: state hash {roots[-1].state_hash().hex()} at height {STATE_BLOCKS}; "
        f"recoveries {', '.join(f'{m:.3f}' for m in recover_ms)} ms")
    keep.update(store=store, keys=inp["keys"], addrs=inp["addrs"], accounts=inp["accounts"],
                roots=roots[-1], block=blocks[-1])
    return launches, warm


# the execution phase (block_exec_1m): blocks 3-6 executed by the node's own
# code (core/block_manager, tx_pool, block_producer, system contracts, the
# WASM VM) on state_commit_1m's store
EXEC_TXS = STATE_TXS  # signed transfers a block at heights 3 and 4
EXEC_OVERDRAWN = 16  # of them asking for more than their sender holds
EXEC_COUNTERS = 16  # counter contracts deployed at height 5, and one proxy
EXEC_TOKEN_CALLS = 64  # native_token transfer calls at height 5
EXEC_VALIDATORS = 32  # senders that stake and submit a VRF proof at height 5
EXEC_STAKE = 10**21
EXEC_CALLS = 2  # counter calls a sender at height 6
EXEC_PROXIED = 512  # of them through the proxy
EXEC_CALL_GAS = 10**9
EXEC_LANES = 8
EXEC_SAMPLES = 100  # receipts read back after the reopen
OUT_OF_GAS = TRANSFER_GAS + 50_000  # an inc() call's gas limit that its storage write exceeds
MAX_U256 = (1 << 256) - 1


def counter_contract(builder, abi) -> bytes:
    """The counter of the JAX package's tests/test_vm.py:269, assembled by
    `builder` (either package's vm/builder.py): storage key 32 zero bytes
    holds an i64 (LE); inc() adds one and returns it, get() returns it,
    any other selector traps."""
    Op, I32 = builder.Op, builder.I32
    b = builder.ModuleBuilder()
    copy_call = b.add_import("env", "copy_call_value", [I32, I32, I32], [])
    load_st = b.add_import("env", "load_storage", [I32, I32], [])
    save_st = b.add_import("env", "save_storage", [I32, I32], [])
    set_ret = b.add_import("env", "set_return", [I32, I32], [])
    b.add_memory(1)
    sel_inc = int.from_bytes(abi.method_selector("inc()"), "little")
    sel_get = int.from_bytes(abi.method_selector("get()"), "little")
    body = [
        Op.i32_const(0), Op.i32_const(4), Op.i32_const(0), Op.call(copy_call),
        Op.i32_const(64), Op.i32_const(96), Op.call(load_st),
        Op.i32_const(0), Op.i32_load(), Op.i32_const(sel_inc), Op.i32_eq,
        Op.if_(),
        Op.i32_const(96),
        Op.i32_const(96), Op.i64_load(), Op.i64_const(1), Op.i64_add,
        Op.i64_store(),
        Op.i32_const(64), Op.i32_const(96), Op.call(save_st),
        Op.i32_const(96), Op.i32_const(8), Op.call(set_ret),
        Op.return_,
        Op.end,
        Op.i32_const(0), Op.i32_load(), Op.i32_const(sel_get), Op.i32_eq,
        Op.if_(),
        Op.i32_const(96), Op.i32_const(8), Op.call(set_ret),
        Op.return_,
        Op.end,
        Op.unreachable,
    ]
    b.add_function([], [], [], body, export="start")
    return b.build()


def proxy_contract(builder) -> bytes:
    """The proxy of the JAX package's tests/test_vm.py:309: forwards
    calldata[20:] to the contract at calldata[0:20] with all its gas and
    returns the child's return value; a failed child traps it."""
    Op, I32, I64 = builder.Op, builder.I32, builder.I64
    b = builder.ModuleBuilder()
    copy_call = b.add_import("env", "copy_call_value", [I32, I32, I32], [])
    call_size = b.add_import("env", "get_call_size", [], [I32])
    invoke = b.add_import("env", "invoke_contract", [I32, I32, I32, I32, I64], [I32])
    ret_size = b.add_import("env", "get_return_size", [], [I32])
    copy_ret = b.add_import("env", "copy_return_value", [I32, I32, I32], [])
    set_ret = b.add_import("env", "set_return", [I32, I32], [])
    b.add_memory(1)
    body = [
        Op.i32_const(0), Op.i32_const(20), Op.i32_const(0), Op.call(copy_call),
        Op.i32_const(20), Op.call(call_size), Op.i32_const(32), Op.call(copy_call),
        Op.i32_const(0), Op.i32_const(32),
        Op.call(call_size), Op.i32_const(20), Op.i32_sub,
        Op.i32_const(512), Op.i64_const(0),
        Op.call(invoke),
        Op.i32_eqz, Op.if_(), Op.unreachable, Op.end,
        Op.i32_const(1024), Op.i32_const(0), Op.call(ret_size), Op.call(copy_ret),
        Op.i32_const(1024), Op.call(ret_size), Op.call(set_ret),
    ]
    b.add_function([], [], [], body, export="start")
    return b.build()


def tx_timelines(label: str, hashes) -> None:
    """The txtrace timelines of the sampled transactions among `hashes`
    (utils/txtrace.py, 1 in 2^sample_shift by hash prefix): every sampled
    one has a timeline that runs pool -> propose -> exec -> commit in order,
    its stages summing to its end-to-end span; printed: their count and
    the median of each stage's seconds and of the end-to-end span."""
    import statistics

    from lachain_tpu_torch.utils import txtrace

    sampled = [h for h in hashes if txtrace.sampled(h)]
    tls = [txtrace.timeline(h) for h in sampled]
    check(sampled and all(tl is not None for tl in tls),
          f"{label}: {len(sampled)} sampled transactions, a timeline missing")
    order = ["pool", "propose", "exec", "commit"]
    for tl in tls:
        check([st["stage"] for st in tl["stages"]] == order,
              f"{label}: timeline {tl['traceId']} runs {[st['stage'] for st in tl['stages']]}")
        check(abs(sum(st["dur_s"] for st in tl["stages"]) - tl["e2e_s"]) <= 1e-5,
              f"{label}: timeline {tl['traceId']}'s stages do not sum to its e2e")
    med = {st: statistics.median(tl["stages"][i]["dur_s"] for tl in tls)
           for i, st in enumerate(order)}
    log(f"{label}: txtrace timelines of {len(tls)} sampled transfers (1 in "
        f"{1 << txtrace.sample_shift()} of {len(hashes)}), each pool -> propose -> exec -> "
        f"commit, stages summing to e2e; median seconds "
        + ", ".join(f"{k} {v:.6f}" for k, v in med.items())
        + f", e2e {statistics.median(tl['e2e_s'] for tl in tls):.6f}")


def run_exec_path(seed: int, dev, keep: dict):
    """Execution at full width on state_commit_1m's store (`keep`: the
    1,000,000-account state on LsmKV at height 2): one validator's
    BlockManager(lanes=1, device=dev) with the system contracts'
    executer, a TransactionPool over the same store and a
    BlockProducer(n_validators=1, txs_per_block=EXEC_TXS). Four seeded
    blocks, nonces read from the committed state: heights 3 and 4 of
    EXEC_TXS transfers from the 1,024 senders to genesis accounts,
    EXEC_OVERDRAWN of them asking for more than their sender holds (the
    last of their sender's chain); height 5: EXEC_COUNTERS counters and a
    proxy deployed through DEPLOY_ADDRESS, EXEC_TOKEN_CALLS native_token
    transfers, EXEC_VALIDATORS senders' becomeStaker then submitVrf;
    height 6: EXEC_CALLS inc() calls a sender on the counters,
    EXEC_PROXIED of them through the proxy, one out of gas and one with a
    bad selector. Each block enters the pool as a node's bulk ingest
    enters it (precheck, one warm_sender_caches on `dev`: exactly
    recover_launches(n), each sender its signing key's address; then
    add), and is produced as a node produces it
    (get_transactions_to_propose, create_header, produce_block with the
    state hash checked): no kernel launched there, every receipt's status
    the harness's. Then blocks 4 and 6 emulated again over their parents'
    roots on fresh StateManagers, the emulate memo cleared, serially and
    with EXEC_LANES lanes (whose parallel path must run): the committed
    state hashes and receipts. The store closed and reopened: height 6,
    the roots of heights 2-6, the blocks, EXEC_SAMPLES receipts and
    transactions, the blooms, one sender's address index, a clean quick
    fsck, and each counter's get() through VirtualMachine on height 6's
    snapshot equal to its successful inc() calls."""
    import torch

    from lachain_tpu_torch.core import block_manager as bm_mod
    from lachain_tpu_torch.core import execution, types
    from lachain_tpu_torch.core import system_contracts as sc
    from lachain_tpu_torch.core.block_manager import BlockManager
    from lachain_tpu_torch.core.block_producer import BlockProducer
    from lachain_tpu_torch.core.tx_pool import TransactionPool
    from lachain_tpu_torch.crypto import ecdsa, vrf
    from lachain_tpu_torch.storage.fsck import fsck
    from lachain_tpu_torch.storage.state import StateManager
    from lachain_tpu_torch.utils import bloom
    from lachain_tpu_torch.utils.serialization import write_bytes, write_u64, write_u256
    from lachain_tpu_torch.vm import abi, builder
    from lachain_tpu_torch.vm import vm as wasm_vm

    label = f"block_exec N={STATE_ACCOUNTS}"
    t_path = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    keys, addrs, accts = keep["keys"], keep["addrs"], keep["accounts"]
    senders = len(keys)
    kv = LsmKV(keep["store"])
    state = StateManager(kv)
    bm = BlockManager(kv, state, sc.make_executer(ROOT_CHAIN_ID), lanes=1, device=dev)
    check(bm.current_height() == STATE_BLOCKS and state.committed == keep["roots"],
          f"{label}: state_commit_1m's store is not at height {STATE_BLOCKS}")
    pool = TransactionPool(kv, ROOT_CHAIN_ID,
                           account_nonce=lambda a: execution.get_nonce(state.new_snapshot(), a))
    producer = BlockProducer(bm, pool, n_validators=1, txs_per_block=EXEC_TXS)
    rng = random.Random(seed + 2400)
    signer, stxs_by_hash, expect = {}, {}, {}
    sel_inc, sel_get = abi.method_selector("inc()"), abi.method_selector("get()")

    def sign(k, to, value, nonce, status, gas_price=1, gas_limit=TRANSFER_GAS,
             invocation=b""):
        tx = types.Transaction(to=to, value=value, nonce=nonce, gas_price=gas_price,
                               gas_limit=gas_limit, invocation=invocation)
        stx = types.sign_transaction(tx, keys[k], ROOT_CHAIN_ID)
        signer[stx.hash()] = addrs[k]
        stxs_by_hash[stx.hash()] = stx
        expect[stx.hash()] = status
        return stx

    def nonces():
        snap = state.new_snapshot()
        return [execution.get_nonce(snap, a) for a in addrs]

    def transfers():
        n = nonces()
        over = set(rng.sample(range(senders), EXEC_OVERDRAWN))
        count = [EXEC_TXS // senders + (k < EXEC_TXS % senders) for k in range(senders)]
        out = []
        for t in range(EXEC_TXS):
            k, j = t % senders, t // senders
            bad = k in over and j == count[k] - 1
            out.append(sign(k, accts[rng.randrange(len(accts))],
                            MAX_U256 if bad else rng.randrange(1, 10**9), n[k] + j,
                            0 if bad else 1, gas_price=rng.randrange(1, 100)))
        return out

    counter_code = counter_contract(builder, abi)
    counters = []  # the counters' addresses, then the proxy's
    incs = {}  # counter -> its successful inc() calls

    def deploys_and_system_calls():
        n = nonces()
        counters.extend(wasm_vm.contract_address(addrs[0], n[0] + i)
                        for i in range(EXEC_COUNTERS + 1))
        out = [sign(0, sc.DEPLOY_ADDRESS, 0, n[0] + i, 1,
                    invocation=sc.SEL_DEPLOY + write_bytes(
                        counter_code if i < EXEC_COUNTERS else proxy_contract(builder)))
               for i in range(EXEC_COUNTERS + 1)]
        for k in range(1, 1 + EXEC_TOKEN_CALLS):
            out.append(sign(k, sc.NATIVE_TOKEN_ADDRESS, 0, n[k], 1, invocation=(
                sc.SEL_TRANSFER + accts[rng.randrange(len(accts))]
                + write_u256(rng.randrange(1, 10**6)))))
        vals = list(range(1 + EXEC_TOKEN_CALLS, 1 + EXEC_TOKEN_CALLS + EXEC_VALIDATORS))
        snap = state.new_snapshot()
        alpha = (snap.get("storage", sc.STAKING_ADDRESS + b"seed") or b"genesis-seed") \
            + write_u64((STATE_BLOCKS + 3) // sc.CYCLE_DURATION)
        # the block runs sender by sender: a validator's submitVrf sees the
        # stakes of the validators ordered before it and its own
        for rank, k in enumerate(sorted(vals, key=lambda k: addrs[k])):
            pub = ecdsa.public_key_bytes(keys[k])
            proof, beta = vrf.evaluate(keys[k], alpha)
            wins = vrf.is_winner(beta, EXEC_STAKE, EXEC_STAKE * (rank + 1), 7)
            out.append(sign(k, sc.STAKING_ADDRESS, 0, n[k], 1, invocation=(
                sc.SEL_BECOME_STAKER + write_bytes(pub) + write_u256(EXEC_STAKE))))
            out.append(sign(k, sc.STAKING_ADDRESS, 0, n[k] + 1, int(wins), invocation=(
                sc.SEL_SUBMIT_VRF + write_bytes(pub) + write_bytes(proof))))
        return out

    def contract_calls():
        n = nonces()
        proxy = counters[-1]
        proxied = set(rng.sample(range(2, senders * EXEC_CALLS), EXEC_PROXIED))
        out = []
        for k in range(senders):
            for j in range(EXEC_CALLS):
                c = k * EXEC_CALLS + j
                target = counters[rng.randrange(EXEC_COUNTERS)]
                if c == 0:  # out of gas: its storage write alone costs more
                    out.append(sign(k, target, 0, n[k] + j, 0, gas_limit=OUT_OF_GAS,
                                    invocation=sel_inc))
                elif c == 1:  # a selector the counter does not know: it traps
                    out.append(sign(k, target, 0, n[k] + j, 0, gas_limit=EXEC_CALL_GAS,
                                    invocation=b"\xde\xad\xbe\xef"))
                else:
                    via = c in proxied
                    out.append(sign(k, proxy if via else target, 0, n[k] + j, 1,
                                    gas_limit=EXEC_CALL_GAS,
                                    invocation=(target + sel_inc) if via else sel_inc))
                    incs[target] = incs.get(target, 0) + 1
        return out

    recover_ms, walls, receipts, blocks, roots = [], [], {}, {}, {}
    roots[STATE_BLOCKS] = state.committed
    total = dict.fromkeys(read_launches(), 0)
    wasm = {}

    def produce(height: int, txs) -> None:
        # the node's bulk ingest: precheck, one batch recovery, then add
        types._SENDER_MEMO.clear()
        fresh = [stx for stx in txs if pool.precheck(stx)]
        check(len(fresh) == len(txs), f"{label} block {height}: precheck refused a transaction")
        if on_card:
            torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        types.warm_sender_caches(fresh, ROOT_CHAIN_ID, device=dev)
        rec_s = time.perf_counter() - t0
        ingest = read_launches()
        check_no_escapes(f"{label} block {height} ingest")
        if on_card:
            want = recover_launches(len(fresh))
            check(ingest == want, f"{label} block {height}: ingest launches {ingest} != {want}")
        check([stx.sender(ROOT_CHAIN_ID) for stx in fresh] == [signer[stx.hash()] for stx in fresh],
              f"{label} block {height}: a recovered sender differs from its signing key's")
        for k in total:
            total[k] += ingest[k]
        t0 = time.perf_counter()
        added = sum(pool.add(stx) for stx in fresh)
        add_s = time.perf_counter() - t0
        check(added == len(fresh), f"{label} block {height}: the pool admitted {added}")
        # the node's production: proposal, header (order, emulate), block
        reset_counts()
        t0 = time.perf_counter()
        proposal = producer.get_transactions_to_propose()
        propose_s = time.perf_counter() - t0
        check(sorted(t.hash() for t in proposal) == sorted(t.hash() for t in txs),
              f"{label} block {height}: the proposal is not the block's {len(txs)} transactions")
        t0 = time.perf_counter()
        header = producer.create_header(height, proposal, nonce=height)
        header_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        block = producer.produce_block(header, proposal, types.MultiSig(()))
        produce_s = time.perf_counter() - t0
        launched = {k: v for k, v in read_launches().items() if v}
        check(not launched, f"{label} block {height}: production launched {launched} (the "
              f"ingest warmed every sender)")
        check(bm.current_height() == height and state.committed.state_hash()
              == header.state_hash and len(pool) == 0,
              f"{label} block {height}: height, state hash or pool after the commit")
        t0 = time.perf_counter()
        recs = [bm.receipt_by_hash(h) for h in block.tx_hashes]
        read_s = time.perf_counter() - t0
        got = [types.TransactionReceipt.decode(r) for r in recs]
        bad = [r.tx_hash.hex()[:16] for r in got if r.status != expect[r.tx_hash]]
        check(not bad and len(got) == len(txs),
              f"{label} block {height}: receipts {bad[:4]} differ from the expected statuses")
        receipts[height] = dict(zip(block.tx_hashes, recs))
        blocks[height], roots[height] = block, state.committed
        ok = sum(r.status for r in got)
        if height == STATE_BLOCKS + 4:
            wasm.update(gas=sum(r.gas_used - TRANSFER_GAS for r in got), s=header_s)
        recover_ms.append(rec_s * 1e3)
        log(f"{label} block {height}: {len(txs)} transactions; ingest: {len(fresh)} senders "
            f"recovered on {dev} in {rec_s * 1e3:.3f} ms (wall), phases "
            f"{phase_line(ecdsa.batch_recoverer(dev).last_timings) if on_card else 'cpu'}, "
            f"pool.add {add_s:.3f} s; proposal {propose_s:.3f} s, create_header "
            f"{header_s:.3f} s, produce_block {produce_s:.3f} s: "
            f"{len(txs) / (header_s + produce_s):.0f} transactions a second; receipts "
            f"{ok} ok / {len(got) - ok} failed (read back in {read_s:.3f} s); state hash "
            f"{header.state_hash.hex()[:16]}")
        walls.append(dict(recover_s=rec_s, add_s=add_s, create_header_s=header_s,
                          produce_block_s=produce_s, wall_s=rec_s + add_s + header_s + produce_s))

    t0 = time.perf_counter()
    txs3 = transfers()
    sign3 = time.perf_counter() - t0
    log(f"{label}: block {STATE_BLOCKS + 1}'s {len(txs3)} transfers signed natively in "
        f"{sign3:.3f} s")
    produce(STATE_BLOCKS + 1, txs3)
    produce(STATE_BLOCKS + 2, transfers())
    t0 = time.perf_counter()
    txs5 = deploys_and_system_calls()
    log(f"{label}: block {STATE_BLOCKS + 3}'s {len(txs5)} deploys and system calls signed "
        f"({EXEC_VALIDATORS} VRF proofs) in {time.perf_counter() - t0:.3f} s; "
        f"{sum(expect[t.hash()] for t in txs5[-2 * EXEC_VALIDATORS + 1::2])} of "
        f"{EXEC_VALIDATORS} VRF proofs win")
    produce(STATE_BLOCKS + 3, txs5)
    snap = state.new_snapshot()
    check(all(wasm_vm.get_code(snap, c) is not None for c in counters),
          f"{label}: a deployed contract has no code")
    produce(STATE_BLOCKS + 4, contract_calls())
    log(f"{label}: the WASM calls of block {STATE_BLOCKS + 4}: {wasm['gas']} gas above the "
        f"base transfer's, emulated in {wasm['s']:.3f} s (create_header)")
    tx_timelines(label, [h for height in sorted(blocks) for h in blocks[height].tx_hashes])

    # the lanes: blocks 4 and 6 again over their parents' roots, memo cleared
    reset_counts()
    for height in (STATE_BLOCKS + 2, STATE_BLOCKS + 4):
        block = blocks[height]
        ordered = [stxs_by_hash[h] for h in block.tx_hashes]
        ems, secs = {}, {}
        for lanes in (1, EXEC_LANES):
            bm_mod._EMULATE_MEMO.clear()
            other = BlockManager(kv, StateManager(kv), sc.make_executer(ROOT_CHAIN_ID),
                                 lanes=lanes, device=dev)
            t0 = time.perf_counter()
            ems[lanes] = other.emulate(ordered, height, base=roots[height - 1])
            secs[lanes] = time.perf_counter() - t0
            stats = other.last_parallel_stats
            del other
        bm_mod._EMULATE_MEMO.clear()
        # the planner may coalesce a block into one lane (every call of
        # block 6 meets the others at the proxy or a counter); the lane
        # pipeline runs all the same
        check(stats is not None and stats.txs == len(ordered),
              f"{label} block {height}: the lanes' parallel path did not run")
        want = [receipts[height][h] for h in block.tx_hashes]
        for lanes, em in ems.items():
            check(em.state_hash == block.header.state_hash
                  and [r.encode() for r in em.receipts] == want,
                  f"{label} block {height}: lanes={lanes} differs from the serial commit")
        log(f"{label} block {height} lanes check: serial emulate {secs[1]:.3f} s, "
            f"{EXEC_LANES} lanes {secs[EXEC_LANES]:.3f} s ({stats.lanes} lanes, the largest "
            f"{max(stats.lane_sizes)} transactions, {stats.validated} validated, "
            f"{stats.stragglers} stragglers): both equal the committed state hash and receipts")
    launched = {k: v for k, v in read_launches().items() if v}
    check(not launched, f"{label}: the lanes check launched {launched}")

    # the reopened store
    blooms = {h: bm.bloom_by_height(h) for h in blocks}
    kv.close()
    t0 = time.perf_counter()
    kv = LsmKV(keep["store"])
    state = StateManager(kv)
    bm = BlockManager(kv, state, sc.make_executer(ROOT_CHAIN_ID), device=dev)
    last = STATE_BLOCKS + 4
    check(bm.current_height() == last
          and all(state.roots_at(h) == roots[h] for h in range(STATE_BLOCKS, last + 1)),
          f"{label}: the reopened store's height or roots differ")
    for h, block in blocks.items():
        check(bm.block_by_height(h).encode() == block.encode()
              and bm.bloom_by_height(h) == blooms[h],
              f"{label}: block {h} or its bloom read back wrong")
    check(all(blooms[h] == bytes(bloom.BLOOM_BYTES) for h in (last - 3, last - 2, last))
          and all(bloom.contains(blooms[last - 1], a) for a in (
              sc.DEPLOY_ADDRESS, sc.NATIVE_TOKEN_ADDRESS, sc.STAKING_ADDRESS)),
          f"{label}: the blooms' addresses")
    sample = random.Random(seed + 2401).sample(sorted(stxs_by_hash), EXEC_SAMPLES)
    by_height = {th: h for h, b in blocks.items() for th in b.tx_hashes}
    check(all(bm.receipt_by_hash(th) == receipts[by_height[th]][th]
              and bm.transaction_by_hash(th).encode() == stxs_by_hash[th].encode()
              for th in sample), f"{label}: a sampled receipt or transaction read back wrong")
    who = addrs[senders // 2]
    want = {(by_height[th], th) for th, stx in stxs_by_hash.items()
            if signer[th] == who or stx.tx.to == who}
    got = bm.transactions_by_address(who, limit=10 * len(want) + 10)
    check(set(got) == want and got == sorted(got, reverse=True),
          f"{label}: the address index of {who.hex()} has {len(got)} entries, want {len(want)}")
    t1 = time.perf_counter()
    report = fsck(kv, repair=False)
    fsck_s = time.perf_counter() - t1
    check(report.clean, f"{label}: quick fsck after the reopen: {report.to_dict()}")
    snap = state.new_snapshot(state.roots_at(last))
    for c in counters[:-1]:
        machine = wasm_vm.VirtualMachine(snap, block_index=last + 1, origin=addrs[0],
                                         gas_price=1, chain_id=ROOT_CHAIN_ID)
        res = machine.invoke_contract(contract=c, sender=addrs[0], value=0, input=sel_get,
                                      gas_limit=EXEC_CALL_GAS)
        check(res.status == 1 and int.from_bytes(res.return_data, "little") == incs.get(c, 0),
              f"{label}: counter {c.hex()} reads {res.return_data.hex()}, "
              f"{incs.get(c, 0)} inc() calls succeeded")
    log(f"{label}: reopened in {time.perf_counter() - t0:.3f} s: height {last}, the roots of "
        f"heights {STATE_BLOCKS}-{last}, every block and bloom, {EXEC_SAMPLES} sampled "
        f"receipts and transactions, {len(want)} entries of {who.hex()[:8]}'s address index, "
        f"quick fsck clean in {fsck_s:.3f} s, {EXEC_COUNTERS} counters' get() equal to their "
        f"{sum(incs.values())} successful inc() calls; LsmKV {kv.stats()}")
    kv.close()
    log(f"{label}: path wall {time.perf_counter() - t_path:.3f} s; recoveries "
        f"{', '.join(f'{m:.3f}' for m in recover_ms)} ms")
    return total, walls


# ---------------------------------------------------------------------------
# validator rotation: the stake, the VRF lottery, the on-chain DKG, the wallet
# and the key switch at the cycle boundary
# ---------------------------------------------------------------------------

# rotation_64: BASELINE config 4's validator set (N=64, f=21) rotated to its
# own DKG's keys over one cycle of the reference tests' parameters
# (set_cycle_params(20, 10, 5), lachain_tpu/tests/test_attendance_onchain.py:29-31)
ROT_N = 64
ROT_CYCLE, ROT_VRF_PHASE, ROT_ATTENDANCE = 20, 10, 5
ROT_ABSENT = 2  # seeded absentees a block among the era's co-signers
ROT_STAKE = 1  # each validator's stake: with validators_count = N every roll wins
ROT_GAS = 100_000  # a system transaction's gas limit (ref core/node.py:940)
ROT_BALANCE = 10**24
ROT_TXS = 10_000  # the producer's block size: room for half a value round (2,048)
ROT_PASSWORD = "rotation"


def port_modules():
    """The port's modules that RotationChain drives, under the names the
    tests give the JAX package's."""
    from types import SimpleNamespace

    from lachain_tpu_torch.consensus import attendance
    from lachain_tpu_torch.core import (block_manager, block_producer, execution,
                                        system_contracts, tx_pool, types, validator_manager)
    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.storage import kv, state

    return SimpleNamespace(attendance=attendance, block_manager=block_manager,
                           block_producer=block_producer, execution=execution,
                           system_contracts=system_contracts, tx_pool=tx_pool, types=types,
                           validator_manager=validator_manager, ecdsa=ecdsa, kv=kv, state=state)


class RotationChain:
    """One validator's chain for the rotation path, in either package
    (`pkg`: its modules, `port_modules()`'s names), with the node's glue
    that ref core/node.py:930-1075 holds and the port does not have yet:
    genesis funds the validators (`ecdsa_privs`, the genesis set's keys),
    registers them as the attendance electorate and writes the staking
    row `validators_count` = `count`, which the reference reads
    (system_contracts.py:398) but never writes; `send_tx_for(priv)` is a
    validator's `_send_system_tx` (the node's gas limit and price, nonces
    counted here); `produce(absent)` ingests the pending transactions into
    the pool (precheck, `ingest` recovers the senders, add), proposes,
    makes the header, has it co-signed by the era's set
    (ValidatorManager.keys_for_era) but the indices in `absent`, and
    produces the block; `after_block(block, services)` hands the block to
    the services on one snapshot, then records and persists the
    attendance from the block's signatures (ref node.py:979-1001)."""

    def __init__(self, pkg, kv, genesis, ecdsa_privs, chain_id: int, *, count: int,
                 device=None, ingest=None):
        self.pkg, self.kv, self.chain_id = pkg, kv, chain_id
        self.state = pkg.state.StateManager(kv)
        kw = {} if device is None else {"device": device}
        self.bm = pkg.block_manager.BlockManager(
            kv, self.state, pkg.system_contracts.make_executer(chain_id), **kw)
        self.pool = pkg.tx_pool.TransactionPool(
            kv, chain_id,
            account_nonce=lambda a: pkg.execution.get_nonce(self.state.new_snapshot(), a))
        self.producer = pkg.block_producer.BlockProducer(self.bm, self.pool, n_validators=1,
                                                         txs_per_block=ROT_TXS)
        self.priv_of = {pkg.ecdsa.public_key_bytes(p): p for p in ecdsa_privs}
        self.ingest = ingest or self.warm_on_host
        self.pending, self.nonces, self.signer = [], {}, {}
        sc = pkg.system_contracts
        register = sc.register_genesis_validators

        def with_count(snap, pubkeys):
            register(snap, pubkeys)
            snap.put("storage", sc.STAKING_ADDRESS + b"validators_count",
                     count.to_bytes(4, "big"))

        sc.register_genesis_validators = with_count
        try:
            self.bm.build_genesis({self.address(p): ROT_BALANCE for p in ecdsa_privs}, chain_id,
                                  validator_pubs=list(genesis.ecdsa_pub_keys))
        finally:
            sc.register_genesis_validators = register
        self.vm = pkg.validator_manager.ValidatorManager(self.state, genesis)
        self.attendance = pkg.attendance.ValidatorAttendance(0)

    def address(self, priv: bytes) -> bytes:
        e = self.pkg.ecdsa
        return e.address_from_public_key(e.public_key_bytes(priv))

    def send_tx_for(self, priv: bytes):
        addr = self.address(priv)

        def send(to: bytes, invocation: bytes) -> None:
            nonce = self.nonces.get(addr, 0)
            self.nonces[addr] = nonce + 1
            tx = self.pkg.types.Transaction(to=to, value=0, nonce=nonce, gas_price=1,
                                            gas_limit=ROT_GAS, invocation=invocation)
            stx = self.pkg.types.sign_transaction(tx, priv, self.chain_id)
            self.signer[stx.hash()] = addr
            self.pending.append(stx)

        return send

    def warm_on_host(self, txs) -> None:
        for stx in txs:
            stx.sender(self.chain_id)

    def produce(self, absent=()):
        txs, self.pending = self.pending, []
        height = self.bm.current_height() + 1
        fresh = [stx for stx in txs if self.pool.precheck(stx)]
        check(len(fresh) == len(txs), f"rotation block {height}: precheck refused a transaction")
        self.ingest(fresh)
        check(all(stx.sender(self.chain_id) == self.signer[stx.hash()] for stx in fresh),
              f"rotation block {height}: a recovered sender differs from its signing key's")
        added = sum(self.pool.add(stx) for stx in fresh)
        check(added == len(fresh), f"rotation block {height}: the pool admitted {added} of "
              f"{len(fresh)}")
        proposal = self.producer.get_transactions_to_propose()
        check(sorted(t.hash() for t in proposal) == sorted(t.hash() for t in txs),
              f"rotation block {height}: the proposal is not the block's {len(txs)} transactions")
        header = self.producer.create_header(height, proposal, nonce=height)
        keys = self.vm.keys_for_era(height)
        h = header.hash()
        multisig = self.pkg.types.MultiSig(tuple(
            (i, self.pkg.ecdsa.sign_hash(self.priv_of[pk], h))
            for i, pk in enumerate(keys.ecdsa_pub_keys) if i not in absent))
        block = self.producer.produce_block(header, proposal, multisig)
        check(self.bm.current_height() == height and len(self.pool) == 0,
              f"rotation block {height}: the height or the pool after the commit")
        return block

    def after_block(self, block, services) -> None:
        snap = self.state.new_snapshot()
        for s in services:
            s.on_block_persisted(block, snap)
        self.record_attendance(block)

    def record_attendance(self, block) -> None:
        keys = self.vm.keys_for_era(block.header.index)
        cycle = block.header.index // self.pkg.system_contracts.CYCLE_DURATION
        if cycle > self.attendance.next_cycle:
            self.attendance = self.pkg.attendance.ValidatorAttendance.from_bytes(
                self.attendance.to_bytes(), cycle, current_as_next=False)
        for idx, _sig in block.multisig.signatures:
            if 0 <= idx < len(keys.ecdsa_pub_keys):
                self.attendance.increment(keys.ecdsa_pub_keys[idx], cycle)
        kv = self.pkg.kv
        self.kv.put(kv.prefixed(kv.EntryPrefix.VALIDATOR_ATTENDANCE), self.attendance.to_bytes())

    def events(self, tx_hash: bytes) -> list:
        """The events a transaction emitted (contract || payload)."""
        snap, out = self.state.new_snapshot(), []
        while (raw := snap.get("events", tx_hash + len(out).to_bytes(4, "big"))) is not None:
            out.append(raw)
        return out

    def storage(self, contract: bytes, key: bytes):
        return self.state.new_snapshot().get("storage", contract + key)


def private_keys_matching(wallet, genesis_private, keys, my_index: int, era: int, host):
    """The private shares whose TPKE verification key is slot `my_index`'s
    of the era's public set: the wallet's for the era, else the genesis
    ones (ref core/node.py:1048-1075), or None."""
    from lachain_tpu_torch.crypto import bls12381 as bls

    want = keys.tpke_verification_keys[my_index].y_i
    candidates = [c for c in (wallet.consensus_keys_for_era(era), genesis_private) if c]
    for cand in candidates:
        if cand.tpke_priv is None or cand.tpke_priv.my_id != my_index:
            continue
        if bls.g1_eq(host.g1_mul(bls.G1_GEN, cand.tpke_priv.x_i), want):
            return cand
    return None


def rotation_era(keys, tprivs, seed: int, host):
    """The TPKE era of one block under `keys` (N slots, N decryption shares
    each, `tprivs` the validators' TPKE shares, the first f+1 combined) ->
    (ciphertexts, plaintexts, EraSlotJobs); host work on `host`."""
    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto import tpke
    from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob

    n, f = keys.n, keys.f
    lag = [0] * n
    for i, c in zip(range(f + 1), bls.fr_lagrange_coeffs([i + 1 for i in range(f + 1)], at=0)):
        lag[i] = c
    msgs = [bytes([(s * 11 + i) % 256 for i in range(32)]) for s in range(n)]
    cts = [keys.tpke_pub.encrypt(m, s, SeededRng(seed * 1000 + s), host)
           for s, m in enumerate(msgs)]
    shares = [tpke.decrypt_shares_batch(p, cts, host) for p in tprivs]
    jobs = [EraSlotJob([shares[i][s].ui for i in range(n)], list(lag),
                       tpke._hash_uv_to_g2(ct.u, ct.v, host), ct.w) for s, ct in enumerate(cts)]
    return cts, msgs, jobs


def value_schedule(pairs, n: int, f: int):
    """Walk the value round's (dealer, sender) pairs in chain order as every
    validator's DKG acks them -> (acks a dealer, the dealers in the order
    they reached 2f+1 acks, the (dealer, sender) at which f+1 dealers had:
    where handle_send_value first returns True, or None)."""
    acks, finished, fired = [0] * n, [], None
    for d, s in pairs:
        acks[d] += 1
        if acks[d] == 2 * f + 1:
            finished.append(d)
            if len(finished) == f + 1:
                fired = (d, s)
    return acks, finished, fired


def run_rotation_path(seed: int, dev):
    """One cycle of validator rotation at N = ROT_N (64, f = 21), the
    chain on a fresh LsmKV store, driven as one validator's node drives it
    (RotationChain: transactions through TransactionPool, each block's
    senders recovered at its ingest on `dev`, blocks through BlockProducer
    and BlockManager(device=dev), headers co-signed by the era's set but
    ROT_ABSENT seeded absentees, attendance recorded from the signatures).
    set_cycle_params(20, 10, 5). Genesis: the N validators of a trusted
    key set, funded, registered as the electorate, validators_count = N
    (the cut: each stakes ROT_STAKE, so is_winner's seats >= total elects
    all N). Validators' services: N ValidatorStatusManagers (validator
    0's with the chain's attendance) through block 19, then validator 0's;
    validator 0's KeyGenManager on one_card_backend(dev) with a seeded rng,
    persisting into the chain's store, with an on_keys that installs the
    shares into a PrivateWallet file. The other N-1 dealers, senders and
    confirmers are the harness's, with dkg_16's cut (run_dkg_path): a
    seeded polynomial each, real ECIES only for the entries validator 0
    opens, seeded filler of the real length for the others, the last two
    senders other than validator 0 byzantine (random bytes; the true value
    + 1). Blocks: 1 stakes; 2 the N VRF proofs; 11 the lottery's close
    (every status manager offers it; one lands); 12 the N commits; 13 the
    values of N/2 senders (validator 0's among them), after which validator
    0's manager is rebuilt from the store's KEYGEN_STATE row; 14 one
    sender's N values, whose handling is traced by kernel; 15 the other
    values; 16 validator 0's confirm and N-f-1 matching ones from
    the harness (the quorum, validators_changed, on_keys(20, ...): the
    wallet saves, reloads, has keys for era 20, not 19); 19 FinishCycle,
    which validator 0's manager sends after block 18. Then the keys of
    eras 20 and 19 (ValidatorManager), era 20's TPKE and coin eras on the
    manager's backend under the rotated set (validator 0's shares from the
    wallet, matched to its slot, the others from the harness's
    polynomials), block 20 co-signed by the new set, and validator 0's
    attendance detection for cycle 0, which block 21 executes. Checks:
    the N winners in address order, every keygen check, handle_send_value
    True once at the schedule's message, the quorum at the (N-f)-th
    confirm, the confirmed set the polynomials', the resumed state the
    saved one, every slot and coin, the attendance counts the harness's
    signatures and the check-in; exact launches: dkg_launches(N, f, N,
    N(N-1)) in the manager's calls, recover_launches(n) at each ingest,
    TPKE_LAUNCHES and COIN_LAUNCHES for the eras; no escape."""
    import os
    import tempfile

    import torch

    from lachain_tpu_torch.consensus import keygen as kg
    from lachain_tpu_torch.consensus.keys import PublicConsensusKeys, trusted_key_gen
    from lachain_tpu_torch.core import system_contracts as sc
    from lachain_tpu_torch.core import types
    from lachain_tpu_torch.core.keygen_manager import KeyGenManager
    from lachain_tpu_torch.core.validator_status import ValidatorStatusManager
    from lachain_tpu_torch.core.vault import PrivateWallet
    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.crypto import threshold_sig as ts
    from lachain_tpu_torch.crypto import tpke
    from lachain_tpu_torch.storage.kv import EntryPrefix, prefixed
    from lachain_tpu_torch.utils.serialization import Reader, write_bytes, write_u64, write_u256

    n, f = ROT_N, (ROT_N - 1) // 3
    label = f"rotation N={n}"
    on_card = torch.device(dev).type == "cuda"
    old = (sc.CYCLE_DURATION, sc.VRF_SUBMISSION_PHASE, sc.ATTENDANCE_DETECTION_DURATION)
    sc.set_cycle_params(ROT_CYCLE, ROT_VRF_PHASE, ROT_ATTENDANCE)
    tmp = tempfile.mkdtemp(prefix="lachain_rotation_")
    walls: dict = {}
    t_path = time.perf_counter()

    def timed(key: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            walls[key] = walls.get(key, 0.0) + time.perf_counter() - t0

    total = dict.fromkeys(read_launches(), 0)
    manager_launches = dict.fromkeys(total, 0)

    def counted(into: dict, fn, *args):
        """fn(*args) with its launches counted into `into` and `total`."""
        if on_card:
            torch.cuda.synchronize()
        reset_counts()
        out = fn(*args)
        got = read_launches()
        check_no_escapes(label)
        for k in total:
            into[k] += got[k]
            if into is not total:
                total[k] += got[k]
        return out, got

    ingests = []

    def ingest(fresh) -> None:
        types._SENDER_MEMO.clear()
        t0 = time.perf_counter()
        _, got = counted(total, types.warm_sender_caches, fresh, ROOT_CHAIN_ID, dev)
        ingests.append((len(fresh), time.perf_counter() - t0))
        want = recover_launches(len(fresh)) if fresh else dict.fromkeys(got, 0)
        if on_card:
            check(got == want, f"{label}: an ingest of {len(fresh)} launched {got}, want {want}")

    try:
        t0 = time.perf_counter()
        genesis, gprivs = trusted_key_gen(n, f, SeededRng(seed + 2500))
        privs = [p.ecdsa_priv for p in gprivs]
        pubs = list(genesis.ecdsa_pub_keys)
        pub0 = pubs[0]
        store = os.path.join(tmp, "chain")
        kv = LsmKV(store)
        chain = RotationChain(port_modules(), kv, genesis, privs, ROOT_CHAIN_ID, count=n,
                              device=dev, ingest=ingest)
        backend = one_card_backend(dev)
        host = backend.host
        absent_rng = random.Random(seed + 2501)
        signed: dict = {}  # cycle 0's co-signatures a public key, the harness's tally

        def produce(key: str):
            keys = chain.vm.keys_for_era(chain.bm.current_height() + 1)
            absent = set(absent_rng.sample(range(keys.n), ROT_ABSENT))
            block = timed(key, chain.produce, absent)
            if block.header.index < ROT_CYCLE:
                for i, _sig in block.multisig.signatures:
                    signed[keys.ecdsa_pub_keys[i]] = signed.get(keys.ecdsa_pub_keys[i], 0) + 1
            return block

        # validator 0's node: wallet, status manager, keygen manager
        wallet_path = os.path.join(tmp, "node0.wallet")
        wallet = PrivateWallet(wallet_path, ROT_PASSWORD, rng=SeededRng(seed + 2502),
                               ecdsa_priv=privs[0])
        installed = []

        def on_keys(first_era, keyring, participants):
            installed.append((first_era, keyring, list(participants)))
            wallet.add_threshold_keys(first_era, keyring.tpke_priv, keyring.ts_share)

        persist = Tally()
        put_bytes = []

        class PutTally:
            """The chain store as the manager sees it, its puts' bytes kept."""

            def get(self, key):
                return kv.get(key)

            def put(self, key, value):
                put_bytes.append(len(value))
                kv.put(key, value)

        v0_seed = seed * 1_000_003 + 2503

        def make_manager(rng_seed):
            m = KeyGenManager(privs[0], chain.send_tx_for(privs[0]), rng=SeededRng(rng_seed),
                              backend=backend, on_keys=on_keys, kv=PutTally())
            m._persist_state = persist.wrap("persist", m._persist_state)
            return m

        manager = make_manager(v0_seed)
        statuses = [ValidatorStatusManager(
            p, chain.send_tx_for(p),
            attendance_reader=(lambda c: chain.attendance.counts_for(c)) if i == 0 else None)
            for i, p in enumerate(privs)]
        fired = []

        def watch(keygen):
            """handle_send_value's True returns, by (dealer, sender)."""
            inner = keygen.handle_send_value

            def handle(sender, msg):
                out = inner(sender, msg)
                if out:
                    fired.append((msg.proposer, sender))
                return out

            keygen.handle_send_value = handle

        def after(block, key: str, services=None):
            services = statuses if services is None else services
            snap = chain.state.new_snapshot()
            timed("status managers", lambda: [s.on_block_persisted(block, snap)
                                              for s in services])
            timed(key, counted, manager_launches, manager.on_block_persisted, block, snap)
            chain.record_attendance(block)

        walls["setup"] = time.perf_counter() - t0

        # cycle 0: stakes, VRF proofs, the lottery
        for s in statuses:
            s.become_staker(ROT_STAKE)
        after(produce("stake block"), "manager")
        check(len(chain.pending) == n, f"{label}: {len(chain.pending)} VRF submissions, not {n}")
        after(produce("vrf block"), "manager")
        winners = Reader(chain.storage(sc.STAKING_ADDRESS, b"winners:" + write_u64(0))).bytes_list()
        want_winners = sorted(chain.address(p) for p in privs)
        check(winners == want_winners, f"{label}: the winners are not the {n} validators in "
              f"address order")
        while chain.bm.current_height() < ROT_VRF_PHASE:
            after(produce("empty blocks"), "manager")
        check(len(chain.pending) == n and all(
            stx.tx.invocation == sc.SEL_FINISH_LOTTERY for stx in chain.pending),
            f"{label}: the status managers did not each offer the lottery's close")
        lottery = produce("lottery block")
        statuses_ok = [types.TransactionReceipt.decode(chain.bm.receipt_by_hash(h)).status
                       for h in lottery.tx_hashes]
        check(sorted(statuses_ok) == [0] * (n - 1) + [1], f"{label}: lottery closes {statuses_ok}")
        after(lottery, "manager lottery")
        check(manager.keygen is not None, f"{label}: validator 0's DKG did not start")
        participants = Reader(chain.storage(sc.STAKING_ADDRESS, b"next_validators")).bytes_list()
        check(participants == sorted(pubs, key=ecdsa.address_from_public_key),
              f"{label}: next_validators is not the winners' keys in order")
        p0 = participants.index(pub0)
        addr_index = {ecdsa.address_from_public_key(pk): i for i, pk in enumerate(participants)}
        priv_at = [chain.priv_of[pk] for pk in participants]
        others = [i for i in range(n) if i != p0]
        bad_bytes, bad_value = others[-2], others[-1]
        watch(manager.keygen)

        # the harness's dealers: polynomials, commitments in one host call,
        # validator 0's row real, the others filler of the real length
        t0 = time.perf_counter()
        enc = ecdsa.ecies_encrypt
        hrng = SeededRng(seed * 1_000_003 + 2504)
        filler = random.Random(seed * 1_000_003 + 2505)
        row_len = ECIES_OVERHEAD + (f + 1) * bls.FR_BYTES
        val_len = ECIES_OVERHEAD + bls.FR_BYTES
        polys = {d: kg.BiVarSymmetricPolynomial.random(f, SeededRng(seed * 1_000_003 + 2600 + d))
                 for d in others}
        m = len(polys[others[0]].coeffs)
        flat = host.g1_mul_batch([bls.G1_GEN] * (m * len(others)),
                                 [c for d in others for c in polys[d].coeffs])
        for k, d in enumerate(others):
            row = b"".join(bls.fr_to_bytes(c) for c in polys[d].evaluate_row(p0 + 1))
            msg = kg.CommitMessage(kg.Commitment(flat[k * m:(k + 1) * m]), [
                enc(participants[p0], row, hrng) if i == p0 else filler.randbytes(row_len)
                for i in range(n)])
            chain.send_tx_for(priv_at[d])(sc.GOVERNANCE_ADDRESS,
                                          sc.SEL_KEYGEN_COMMIT + write_bytes(msg.to_bytes()))
        walls["harness"] = time.perf_counter() - t0

        commits = produce("commit block")
        check([addr_index[chain.signer[h]] for h in commits.tx_hashes] == list(range(n)),
              f"{label}: the commits did not execute in participant order")
        after(commits, "manager commits")
        check(len(chain.pending) == n, f"{label}: validator 0 sent {len(chain.pending)} values")
        # validator 0's polynomial: its rows, opened by the harness's
        # validators as a chain's would, and a replay of its seeded draw
        t0 = time.perf_counter()
        own = kg.CommitMessage.from_bytes(Reader(chain.bm.transaction_by_hash(
            commits.tx_hashes[p0]).tx.invocation[4:]).bytes_(), host)
        rows = {s: [bls.fr_from_bytes(raw[o:o + bls.FR_BYTES])
                    for o in range(0, len(raw), bls.FR_BYTES)]
                for s, raw in ((s, ecdsa.ecies_decrypt(priv_at[s], own.encrypted_rows[s]))
                               for s in others)}
        polys[p0] = kg.BiVarSymmetricPolynomial.random(f, SeededRng(v0_seed))
        check(all(rows[s] == polys[p0].evaluate_row(s + 1) for s in others),
              f"{label}: validator 0's rows are not its seeded polynomial's")

        at_p0 = [polys[d].evaluate_row(p0 + 1) for d in range(n)]  # F_d(p0+1, .)

        def values_from(s: int) -> None:
            """Sender s's keygenSendValue for every dealer, in commit order."""
            send = chain.send_tx_for(priv_at[s])
            for d in range(n):
                if s == bad_bytes:
                    mine = filler.randbytes(val_len)
                else:
                    v = (bls.fr_eval_poly(at_p0[d], s + 1) + (s == bad_value)) % bls.R
                    mine = enc(participants[p0], bls.fr_to_bytes(v), hrng)
                msg = kg.ValueMessage(d, [mine if i == p0 else filler.randbytes(val_len)
                                          for i in range(n)])
                send(sc.GOVERNANCE_ADDRESS, sc.SEL_KEYGEN_SEND_VALUE + write_u256(d)
                     + write_bytes(msg.to_bytes()))

        first = sorted(sorted(range(n), key=lambda i: (i != p0, i))[:n // 2])
        rest = [s for s in range(n) if s not in first]
        # the traced sender's round ends no dealer (at N=64: 33 of 43 acks)
        traced_sender = rest[0] if len(first) + 1 < 2 * f + 1 else None
        second = [s for s in rest if s != traced_sender]
        for s in first:
            if s != p0:
                values_from(s)
        walls["harness"] += time.perf_counter() - t0
        values_a = produce("value blocks")
        after(values_a, "manager values")
        # a restart: validator 0's manager rebuilt from the store's row
        t0 = time.perf_counter()
        row = kv.get(prefixed(EntryPrefix.KEYGEN_STATE))
        check(row == manager.state_bytes(), f"{label}: the stored KEYGEN_STATE is not the state")
        old_keygen = manager.keygen
        manager, _ = counted(manager_launches, make_manager, v0_seed + 1)
        check(manager.keygen == old_keygen and manager.state_bytes() == row,
              f"{label}: the resumed state differs from the saved one")
        watch(manager.keygen)
        walls["resume"] = time.perf_counter() - t0
        # one sender's value round (its N values) in a block of its own,
        # its handling traced by kernel; then the other senders'
        values_t, traced = None, {}
        if traced_sender is not None:
            t0 = time.perf_counter()
            values_from(traced_sender)
            walls["harness"] += time.perf_counter() - t0
            values_t = produce("value blocks")
            before = dict(manager_launches)

            def value_round():
                t = time.perf_counter()
                after(values_t, "manager values")
                traced["wall"] = time.perf_counter() - t

            t0 = time.perf_counter()
            if on_card:
                traced["by_kernel"] = profile_device(
                    value_round, warm=lambda: torch.arange(1 << 12, device=dev).sum().item())
            else:
                value_round()
            walls["trace"] = time.perf_counter() - t0 - traced["wall"]  # the profiler's own
            traced["counted"] = {k: manager_launches[k] - before[k] for k in before}
        t0 = time.perf_counter()
        for s in second:
            values_from(s)
        walls["harness"] += time.perf_counter() - t0
        values_b = produce("value blocks")

        def value_pairs(block) -> list:
            out = []
            for h in block.tx_hashes:
                inv = chain.bm.transaction_by_hash(h).tx.invocation
                if inv.startswith(sc.SEL_KEYGEN_SEND_VALUE):
                    out.append((int.from_bytes(inv[4:36], "big"), addr_index[chain.signer[h]]))
            return out

        acks, order, when = timed("schedule", lambda: value_schedule(
            [p for b in (values_a, values_t, values_b) if b for p in value_pairs(b)], n, f))
        after(values_b, "manager values")
        check(acks == [n] * n and manager.keygen.finished_dealers == order,
              f"{label}: acks {acks}, finished dealers {manager.keygen.finished_dealers}")
        check(fired == [when], f"{label}: handle_send_value True at {fired}, the schedule's "
              f"{when}")
        st = manager.keygen.states[p0]
        check(st.acks == [True] * n and [not v for v in st.valid] == [
            i in (bad_bytes, bad_value) for i in range(n)],
            f"{label}: the own dealer's acks / valid {st.acks} / {st.valid}")

        # the confirm: the set the first f+1 finished dealers' polynomials give
        t0 = time.perf_counter()
        at_zero = [polys[d].evaluate_row(0) for d in order[:f + 1]]
        shares = [sum(bls.fr_eval_poly(r, j) for r in at_zero) % bls.R for j in range(n + 1)]
        points = host.g1_mul_batch([bls.G1_GEN] * (n + 1), shares)
        want_keys = PublicConsensusKeys(
            n=n, f=f, tpke_pub=tpke.TpkePublicKey(points[0], t=f),
            tpke_verification_keys=[tpke.TpkeVerificationKey(y) for y in points[1:]],
            ts_keys=ts.TsPublicKeySet([ts.TsPublicKey(y) for y in points[1:]], t=f),
            ecdsa_pub_keys=participants).encode()
        check(len(chain.pending) == 1 and chain.pending[0].tx.invocation
              == sc.SEL_KEYGEN_CONFIRM + write_bytes(want_keys),
              f"{label}: validator 0's confirm is not the polynomials' key set")
        for s in others[:n - f - 1]:
            chain.send_tx_for(priv_at[s])(sc.GOVERNANCE_ADDRESS,
                                          sc.SEL_KEYGEN_CONFIRM + write_bytes(want_keys))
        walls["harness"] += time.perf_counter() - t0
        confirms = produce("confirm block")
        changed = [i for i, h in enumerate(confirms.tx_hashes)
                   if any(e.startswith(sc.GOVERNANCE_ADDRESS + b"validators_changed")
                          for e in chain.events(h))]
        check(changed == [n - f - 1], f"{label}: validators_changed at confirms {changed}, "
              f"not at the {n - f}th")
        after(confirms, "manager confirm")
        check(len(installed) == 1 and installed[0][0] == ROT_CYCLE
              and installed[0][2] == participants,
              f"{label}: on_keys {[(e, len(p)) for e, _, p in installed]}")
        t0 = time.perf_counter()
        reloaded = PrivateWallet.load(wallet_path, ROT_PASSWORD, rng=SeededRng(seed + 2506))
        check(reloaded.has_keys_for_era(ROT_CYCLE) and not reloaded.has_keys_for_era(ROT_CYCLE - 1)
              and reloaded.threshold_keys_for_era(ROT_CYCLE)[0].to_bytes()
              == installed[0][1].tpke_priv.to_bytes(),
              f"{label}: the reloaded wallet's keys for eras {ROT_CYCLE - 1} / {ROT_CYCLE}")
        walls["wallet"] = time.perf_counter() - t0
        while chain.bm.current_height() < ROT_CYCLE - 2:
            after(produce("empty blocks"), "manager")
        check(len(chain.pending) == 1 and chain.pending[0].tx.invocation == sc.SEL_FINISH_CYCLE,
              f"{label}: validator 0 did not offer FinishCycle after block {ROT_CYCLE - 2}")
        finish = produce("finish block")
        check([types.TransactionReceipt.decode(chain.bm.receipt_by_hash(h)).status
               for h in finish.tx_hashes] == [1], f"{label}: FinishCycle failed")
        after(finish, "manager")

        # cycle 1: the rotated set, validator 0's shares from the wallet
        t0 = time.perf_counter()
        keys20 = chain.vm.keys_for_era(ROT_CYCLE)
        check(keys20.encode() == want_keys and chain.vm.keys_for_era(ROT_CYCLE - 1) is genesis,
              f"{label}: keys_for_era({ROT_CYCLE}) is not the DKG's set or "
              f"keys_for_era({ROT_CYCLE - 1}) not the genesis set")
        my = keys20.ecdsa_pub_keys.index(pub0)
        mine = private_keys_matching(reloaded, gprivs[0], keys20, my, ROT_CYCLE, host)
        check(mine is not None and mine.tpke_priv.x_i == shares[my + 1],
              f"{label}: no private shares of the wallet match slot {my} of era {ROT_CYCLE}")
        tprivs = [mine.tpke_priv if i == my else tpke.TpkePrivateKey(shares[i + 1], i)
                  for i in range(n)]
        tsprivs = [mine.ts_share if i == my else ts.TsPrivateKeyShare(shares[i + 1], i)
                   for i in range(n)]
        cts, msgs, jobs = rotation_era(keys20, tprivs, seed + 2507, host)
        signers = [my] + [i for i in range(n) if i != my][:f + 2]
        coins = []
        for c in range(n):
            cmsg = b"coin|era=%d|id=%d" % (ROT_CYCLE, c)
            coins.append((cmsg, {i: tsprivs[i].sign(cmsg, host) for i in signers}))
        walls["era setup"] = time.perf_counter() - t0
        era_launches = dict.fromkeys(total, 0)
        t0 = time.perf_counter()
        res, got = counted(era_launches, backend.tpke_era_verify_combine, jobs,
                           keys20.tpke_verification_keys, SeededRng(seed + 2508))
        walls["tpke era"] = time.perf_counter() - t0
        check(all(ok and tpke.decrypt_with_combined(ct, comb) == msg
                  for (ok, comb), ct, msg in zip(res, cts, msgs)),
              f"{label}: a slot of era {ROT_CYCLE} failed under the rotated keys")
        if on_card:
            check({k: got[k] for k in TPKE_LAUNCHES} == TPKE_LAUNCHES,
                  f"{label}: TPKE era launches {got}")
        t0 = time.perf_counter()
        sigs, got = counted(era_launches, ts.era_verify_combine, keys20.ts_keys, coins,
                            SeededRng(seed + 2509), backend)
        walls["coin era"] = time.perf_counter() - t0
        check(all(sig is not None and keys20.ts_keys.shared.verify(cmsg, sig, host)
                  for (cmsg, _), sig in zip(coins, sigs)),
              f"{label}: a coin of era {ROT_CYCLE} failed under the rotated keys")
        if on_card:
            check({k: got[k] for k in COIN_LAUNCHES} == COIN_LAUNCHES,
                  f"{label}: coin era launches {got}")

        # block 20 under the new set; validator 0 reports cycle 0's attendance
        first_new = produce("cycle 1 blocks")
        check(len(first_new.multisig.signatures) == n - ROT_ABSENT
              and all(ecdsa.verify_hash(keys20.ecdsa_pub_keys[i], first_new.header.hash(), sig)
                      for i, sig in first_new.multisig.signatures),
              f"{label}: block {ROT_CYCLE} is not co-signed by the new set")
        after(first_new, "manager", statuses[:1])
        counts = chain.attendance.counts_for(0)
        row = kv.get(prefixed(EntryPrefix.VALIDATOR_ATTENDANCE))
        check(counts == signed and row == chain.attendance.to_bytes(),
              f"{label}: the recorded attendance differs from the harness's signatures")
        prev = Reader(chain.storage(sc.STAKING_ADDRESS, b"prev_pubs")).bytes_list()
        want_report = sc.SEL_SUBMIT_ATTENDANCE + len(prev).to_bytes(4, "big") + b"".join(
            write_bytes(pk + min(signed.get(pk, 0), ROT_CYCLE).to_bytes(4, "big")) for pk in prev)
        reports = [stx for stx in chain.pending
                   if stx.tx.invocation.startswith(sc.SEL_SUBMIT_ATTENDANCE)]
        check(prev == pubs and len(reports) == 1 and reports[0].tx.invocation == want_report,
              f"{label}: validator 0's attendance report is not the harness's counts over "
              f"the genesis electorate")
        report = produce("cycle 1 blocks")
        checkin = chain.storage(sc.STAKING_ADDRESS, b"att_checkin:" + write_u64(1))
        check(checkin is not None and Reader(checkin).bytes_list() == [pub0],
              f"{label}: the contract did not check validator 0 in for cycle 1")
        after(report, "manager", statuses[:1])
        t0 = time.perf_counter()
        kv.flush()
        disk = dir_bytes(store)
        kv.close()
        walls["close"] = time.perf_counter() - t0
    finally:
        sc.set_cycle_params(*old)
        shutil.rmtree(tmp, ignore_errors=True)

    want = dkg_launches(n, f, n, n * (n - 1))
    if on_card:
        check({k: manager_launches[k] for k in want} == want,
              f"{label}: validator 0's manager launched {manager_launches}, want {want}")
    wall = time.perf_counter() - t_path
    walls["untimed"] = wall - sum(walls.values())
    recovered = sum(k for k, _ in ingests)
    log(f"{label}: the {n} winners in address order; validator 0's DKG resumed from the "
        f"store after the first half of the values, its confirm at dealer {when[0]}'s value "
        f"from sender {when[1]} and the quorum at confirm {n - f}; the key set of the first {f + 1} dealers' polynomials "
        f"installed from era {ROT_CYCLE} (wallet saved and reloaded) and read back by "
        f"keys_for_era; era {ROT_CYCLE}'s {n} slots and {n} coins under it; attendance "
        f"{sum(signed.values())} co-signatures, validator 0 checked in for cycle 1; no host "
        f"recompute; manager launches {want}")
    log(f"{label} walls: " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
        + f"; path {wall:.3f} s")
    log(f"{label} persist: {persist.n.get('persist', 0)} KEYGEN_STATE rows, "
        f"{persist.s.get('persist', 0.0):.3f} s, {sum(put_bytes)} bytes (the last "
        f"{put_bytes[-1]}); ingests of {recovered} senders in {len(ingests)} blocks "
        f"{sum(s for _, s in ingests):.3f} s; store on disk {disk} bytes")
    log(f"{label}: era {ROT_CYCLE} launches {era_launches}")
    if "by_kernel" in traced:
        by_kernel = traced["by_kernel"]
        log(f"{label} sender {traced_sender}'s value round: counted launches "
            f"{ {k: v for k, v in traced['counted'].items() if v} }, traced "
            f"{ {k: by_kernel.get(KERNEL_OF[k], [0, 0])[1] for k in want if want[k]} }")
        busy_line(f"{label} sender {traced_sender}'s value round", by_kernel, traced["wall"])
    return total, [dict(wall_s=wall)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from lachain_tpu_torch.crypto.warmup import warmup_era_kernels
    from lachain_tpu_torch.ops import _build

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds})")
    t0 = time.perf_counter()
    host_lib = _build.host_library()
    log(f"host library: {host_lib._name} ({time.perf_counter() - t0:.1f} s)")
    attrs = _build.kernel_attrs()
    log("kernel attrs (registers, local bytes, threads per lane, block): "
        + ", ".join(f"{k} {a['regs']}/{a['local_bytes']}/{a['threads_per_lane']}/{a['block']}"
                    for k, a in attrs.items()))

    report = check_kernels(args.seed, dev)
    backend = one_card_backend(dev)
    # the node-start warmup, on a backend of its own; the TPKE path's first
    # era follows it
    warmup = warmup_era_kernels(N_VALIDATORS, backend)
    warmup.join()
    check(warmup.error is None, f"warmup failed: {warmup.error!r}")
    log(f"warmup: {warmup.seconds:.2f} s, eras {warmup.eras} (tpke: slots, "
        f"coin: coins; K={N_VALIDATORS})")
    reset_counts()
    t0 = time.perf_counter()
    era = make_era(N_VALIDATORS, args.seed)
    log(f"host setup (dealer, {N_VALIDATORS} ciphertexts, {N_VALIDATORS ** 2} "
        f"shares): {time.perf_counter() - t0:.1f} s")
    runs = [
        ("tpke_era", lambda: run_tpke_path(args.seed, backend, dev, era)),
        ("tpke_flush", lambda: run_flush_path(args.seed, backend, dev, era)),
        ("glv_era", lambda: run_glv_path(args.seed, backend, dev, era)),
        ("coin_era", lambda: run_coin_path(args.seed, backend, dev)),
        ("ecdsa_recover", lambda: run_ecdsa_path(args.seed, dev)),
    ] + [(f"rbc_flush_{n}", lambda n=n: run_rbc_path(args.seed, n, dev)) for n in RBC_ERAS]
    card = torch.device("cuda", torch.cuda.current_device())
    runs += [(f"mesh_era_{m}", lambda n=n: run_mesh_path(
        args.seed, backend, dev, era, [card] * n, [card] * 4 if n == 8 else None))
        for n, m in zip(MESH_SIZES, ("1x1", "2x1", "4x2"))]
    runs.append(("rbc_flush_mesh", lambda: run_rbc_mesh_path(args.seed, dev, [card] * RBC_MESH)))
    root_ref = {}  # root_era_64's block hash and messages, which the native era must equal
    runs += [("root_era_64", lambda: run_root_era_path(args.seed, dev, root_ref)),
             ("root_era_16_check", lambda: run_root_check_path(args.seed, dev)),
             ("root_era_native_64", lambda: run_root_native_path(args.seed, dev, root_ref)),
             ("root_era_native_64_untraced",
              lambda: run_root_native_untraced_path(args.seed, dev, root_ref)),
             ("root_era_native_16_check", lambda: run_root_native_check_path(args.seed, dev))]
    state_ref = {}  # state_commit_1m's store and senders, which block_exec_1m continues on
    runs += [("root_era_adversary_native_64",
              lambda: run_root_adversary_native_path(args.seed, dev)),
             ("root_era_adversary_16", lambda: run_root_adversary_16_path(args.seed, dev)),
             ("chaos_era_16_check", lambda: run_chaos_check_path(args.seed, dev)),
             ("chaos_era_native_16_check", lambda: run_chaos_native_check_path(args.seed, dev)),
             ("root_era_journal_native_64",
              lambda: run_root_journal_native_path(args.seed, dev, root_ref)),
             ("root_era_journal_16", lambda: run_root_journal_path(args.seed, dev)),
             ("dkg_16", lambda: run_dkg_path(args.seed, dev)),
             ("state_commit_1m", lambda: run_state_path(args.seed, dev, state_ref)),
             ("block_exec_1m", lambda: run_exec_path(args.seed, dev, state_ref)),
             ("rotation_64", lambda: run_rotation_path(args.seed, dev))]
    if torch.cuda.device_count() > 1:  # a mesh over distinct cards
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        runs += [("mesh_era_cards", lambda: run_mesh_path(args.seed, backend, dev, era,
                                                          cards, cards)),
                 ("rbc_flush_cards", lambda: run_rbc_mesh_path(args.seed, dev, cards))]
    paths = {}
    try:
        for path, run in runs:
            t0 = time.perf_counter()
            paths[path] = run()
            log(f"path {path}: {time.perf_counter() - t0:.1f} s")
    finally:  # state_commit_1m's store, which block_exec_1m continues on
        if "dir" in state_ref:
            shutil.rmtree(state_ref["dir"], ignore_errors=True)
    g1_path = tuple(k for k in G1_KERNELS if k not in NO_PATH + GLV_ONLY)
    secp_path = tuple(k for k in SECP_KERNELS if k not in NO_PATH)
    needs = {
        "tpke_era": g1_path,
        "tpke_flush": g1_path,
        "glv_era": tuple(k for k in GLV_FIRST if GLV_FIRST[k]),
        "coin_era": g1_path + ("g2_add", "g2_table", "g2_msm_scan"),
        "ecdsa_recover": secp_path,
        "rbc_flush_64": ("rs_matmul8",),
        "rbc_flush_256": ("rs_matmul16",),
        "rbc_flush_mesh": RS_KERNELS,
        "rbc_flush_cards": RS_KERNELS,
        **{f"mesh_era_{m}": g1_path for m in ("1x1", "2x1", "4x2", "cards")},
        "root_era_64": g1_path + ("rs_matmul8",) + secp_path,
        "root_era_16_check": g1_path + ("rs_matmul8",) + secp_path,
        "root_era_native_64": g1_path + ("rs_matmul8",) + secp_path,
        "root_era_native_64_untraced": g1_path + ("rs_matmul8",) + secp_path,
        "root_era_native_16_check": g1_path + ("rs_matmul8",) + secp_path,
        **{p: g1_path + ("rs_matmul8",) + secp_path for p in (
            "root_era_adversary_native_64", "root_era_adversary_16", "chaos_era_16_check",
            "chaos_era_native_16_check", "root_era_journal_native_64", "root_era_journal_16")},
        "dkg_16": ("g1_mont", "g1_table", "g1_msm_scan", "g1_add"),
        "state_commit_1m": secp_path,
        "block_exec_1m": secp_path,
        "rotation_64": g1_path + ("g2_add", "g2_table", "g2_msm_scan") + secp_path,
    }
    for path, (launches, warm) in paths.items():
        missing = [k for k in needs[path] if launches[k] == 0]
        check(not missing, f"{path} never launched: {missing}")
        warm_summary(path, warm)

    sources = dict(
        {k: "g1" for k in G1_KERNELS}, **{k: "g2" for k in G2_KERNELS},
        **{k: "secp" for k in SECP_KERNELS}, **{k: "rs" for k in RS_KERNELS})
    replaces = {
        "fp_mul": "lachain_tpu/ops/pg1.py:262",
        "g1_dbl": "lachain_tpu/ops/pg1.py:253",
        "g1_add": "lachain_tpu/ops/pg1.py:257",
        # build_table's chain of _add_kernel launches (and one
        # _dbl_kernel), pg1.py:447, in one launch
        "g1_table": "lachain_tpu/ops/pg1.py:257",
        "g1_msm_scan": "lachain_tpu/ops/pg1.py:355",
        # XLA device programs of msm.py, not Pallas: the fixed-base tables
        # and the gathers of the y aggregates
        "g1_fixed_tables": "lachain_tpu/ops/msm.py:246",
        "g1_fixed_scan": "lachain_tpu/ops/msm.py:266",
        "g2_dbl": "lachain_tpu/ops/pg2.py:218",
        "g2_add": "lachain_tpu/ops/pg2.py:222",
        # build_table2's chain of _add2_kernel launches (and one
        # _dbl2_kernel), pg2.py:356, in one launch
        "g2_table": "lachain_tpu/ops/pg2.py:222",
        "g2_msm_scan": "lachain_tpu/ops/pg2.py:272",
        # psecp has no launch of its own for the field product: its _mul
        "secp_fp_mul": "lachain_tpu/ops/psecp.py:121",
        # the port's own Montgomery representation: psecp has none
        "secp_mont": "none: the port's own Montgomery form (psecp has none)",
        # the port's own conversions (pg1 has no Montgomery form), and on
        # the TPKE era the product by beta of phi(u) that pg1's era_kernel
        # launches as _mul_kernel (pl_fp_mul)
        "g1_mont": "lachain_tpu/ops/pg1.py:262",
        "secp_dbl": "lachain_tpu/ops/psecp.py:235",
        "secp_add": "lachain_tpu/ops/psecp.py:239",
        # build_table's chain of _add_kernel launches (and one
        # _dbl_kernel), psecp.py:364, in one launch
        "secp_table": "lachain_tpu/ops/psecp.py:239",
        "secp_msm_scan": "lachain_tpu/ops/psecp.py:285",
        "secp_sqrt": "lachain_tpu/ops/psecp.py:380",
        # the jitted GF matmul _mm of _device_jit (plain XLA), one launch
        # per call and field over every group
        "rs_matmul8": "lachain_tpu/ops/rs_batch.py:233",
        "rs_matmul16": "lachain_tpu/ops/rs_batch.py:233",
    }
    def numbers(r: dict) -> dict:
        return {"max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1]}

    kernels = []
    for k, r in report.items():
        entry = {
            "name": k, "route": "cuda",
            "source": f"lachain_tpu_torch/csrc/{sources[k]}.cu",
            "replaces": replaces[k],
            "launches": sum(launches[k] for launches, _ in paths.values()),
            "launches_by_path": {p: v[0][k] for p, v in paths.items()},
            **numbers(r), "library_ms": None, "lanes": r["lanes"],
            "pass": r["ok"], **attrs[k],
        }
        if "main" in r:  # the kernel check above, the main path's layout below
            m = r["main"]
            shape = ("layout", "lanes", "windows")
            entry.update({k: r[k] for k in shape[::2] if k in r},
                         main=dict(numbers(m), **{k: m[k] for k in shape if k in m}))
        entry.update({k: r[k] for k in ("rows", "into_ms", "into_plain_ms", "beta_ms",
                                        "layout") if k in r})
        for extra in ("n256", "odd"):  # fixed-base at N=256; doublings at odd lanes
            if extra in r:
                m = r[extra]
                entry[extra] = dict(numbers(m), **{k: m[k] for k in ("layout", "lanes")
                                                   if k in m})
        if k in RS_KERNELS:  # its shape, and the other shapes it was held at
            rs_keys = ("layout", "lookups", "traced_ms", "int_bound_ms")
            entry.update({x: r[x] for x in rs_keys if x in r},
                         checks=[dict(numbers(c), **{x: c[x] for x in rs_keys if x in c},
                                      **{"pass": c["ok"]})
                                 for c in r.get("checks", ())])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
