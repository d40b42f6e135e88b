"""System contracts: in-process "precompiles" dispatched by address.

The port's copy of `lachain_tpu/core/system_contracts.py`, bytes for bytes
in every row and event it writes:
  * DeployContract      -> address 0x0 (code through `vm.vm.deploy_code`)
  * NativeTokenContract -> 0x1 (the LRC-20 surface)
  * GovernanceContract  -> 0x2 (the keygen message board, the validator
    set change over the port's `consensus/keys.PublicConsensusKeys`, and
    FinishCycle)
  * StakingContract     -> 0x3 (the stake lifecycle, the VRF lottery over
    the port's `crypto/vrf.py`, attendance detection and its settlement)

ABI: 4-byte keccak selector + fixed-width args. Contract storage lives in
the 'storage' subtree under (contract_address || key). The cycle
parameters (`set_cycle_params`) are process-wide, as in the JAX package:
tests set them back between cases.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..crypto import vrf
from ..crypto.hashes import keccak256_host
from ..storage.state import Snapshot
from ..utils.serialization import Reader, write_u32, write_u64, write_u256
from . import execution
from .types import ADDRESS_BYTES, Transaction

DEPLOY_ADDRESS = b"\x00" * 19 + b"\x00"
NATIVE_TOKEN_ADDRESS = b"\x00" * 19 + b"\x01"
GOVERNANCE_ADDRESS = b"\x00" * 19 + b"\x02"
STAKING_ADDRESS = b"\x00" * 19 + b"\x03"

# cycle parameters (reference StakingContract.cs:63-71; config-initialized)
CYCLE_DURATION = 1000  # blocks per validator cycle
VRF_SUBMISSION_PHASE = 500  # blocks of the cycle accepting VRF submissions
ATTENDANCE_DETECTION_DURATION = 100
# per-cycle reward pool distributed by attendance (reference
# DistributeRewardsAndPenalties' totalReward; a validator that skips the
# detection check-in forfeits its share AND accrues that much penalty
# against its stake, StakingContract.cs:656-720)
ATTENDANCE_CYCLE_REWARD = 1000 * 10**18
# how many cycles back a finish tx will lazily settle orphaned attendance
# state (a cycle whose close tx never landed); bounds per-tx work
ATTENDANCE_SETTLE_LOOKBACK = 8


def set_cycle_params(
    cycle_duration: int,
    vrf_submission_phase: int,
    attendance_detection: int = ATTENDANCE_DETECTION_DURATION,
) -> None:
    """Initialize cycle constants from config (reference
    StakingContract.Initialize, StakingContract.cs:186-197). Must be set
    identically on every node before the chain starts."""
    global CYCLE_DURATION, VRF_SUBMISSION_PHASE, ATTENDANCE_DETECTION_DURATION
    assert 0 < vrf_submission_phase < cycle_duration
    # the detection window must CLOSE within the cycle or finish/settlement
    # can never run; clamp deterministically (same config -> same params on
    # every node) rather than brick short-cycle configs
    attendance_detection = max(1, min(attendance_detection, cycle_duration - 1))
    CYCLE_DURATION = cycle_duration
    VRF_SUBMISSION_PHASE = vrf_submission_phase
    ATTENDANCE_DETECTION_DURATION = attendance_detection


def selector(signature: str) -> bytes:
    return keccak256_host(signature.encode())[:4]


# method selectors
SEL_DEPLOY = selector("deploy(bytes)")
SEL_TRANSFER = selector("transfer(address,uint256)")
SEL_BALANCE_OF = selector("balanceOf(address)")
SEL_TOTAL_SUPPLY = selector("totalSupply()")
SEL_BECOME_STAKER = selector("becomeStaker(bytes,uint256)")
SEL_REQUEST_WITHDRAW = selector("requestStakeWithdrawal(bytes)")
SEL_WITHDRAW = selector("withdrawStake(bytes)")
SEL_SUBMIT_VRF = selector("submitVrf(bytes,bytes)")
SEL_FINISH_LOTTERY = selector("finishVrfLottery()")
SEL_GET_STAKE = selector("getStake(address)")
SEL_KEYGEN_COMMIT = selector("keygenCommit(bytes)")
SEL_KEYGEN_SEND_VALUE = selector("keygenSendValue(uint256,bytes)")
SEL_KEYGEN_CONFIRM = selector("keygenConfirm(bytes)")
SEL_CHANGE_VALIDATORS = selector("changeValidators(bytes)")
SEL_FINISH_CYCLE = selector("finishCycle()")
SEL_SUBMIT_ATTENDANCE = selector("submitAttendanceDetection(bytes[],uint256[])")
SEL_FINISH_ATTENDANCE = selector("finishAttendanceDetection()")
SEL_GET_PENALTY = selector("getPenalty(address)")


def _skey(contract: bytes, key: bytes) -> bytes:
    return contract + key


class SystemContractContext:
    """Shared context handed to every contract call."""

    def __init__(self, snap: Snapshot, sender: bytes, tx: Transaction, block: int):
        self.snap = snap
        self.sender = sender
        self.tx = tx
        self.block = block
        self.events: List[Tuple[bytes, bytes]] = []

    # contract-storage accessors ('storage' subtree)
    def sget(self, contract: bytes, key: bytes) -> Optional[bytes]:
        return self.snap.get("storage", _skey(contract, key))

    def sput(self, contract: bytes, key: bytes, value: bytes) -> None:
        self.snap.put("storage", _skey(contract, key), value)

    def sdel(self, contract: bytes, key: bytes) -> None:
        self.snap.delete("storage", _skey(contract, key))

    def emit(self, contract: bytes, data: bytes) -> None:
        self.events.append((contract, data))
        self.snap.put(
            "events",
            keccak256_host(contract + data + write_u64(self.block)),
            contract + data,
        )


# ---------------------------------------------------------------------------
# Deploy (reference DeployContract.cs) — stores contract bytecode; execution
# of deployed code arrives with the VM layer.
# ---------------------------------------------------------------------------


def deploy_contract(ctx: SystemContractContext, args: Reader) -> Tuple[int, bytes]:
    from ..vm.vm import deploy_code

    code = args.bytes_()
    if not code or len(code) > 512 * 1024:
        return 0, b""
    status, addr = deploy_code(ctx.snap, ctx.sender, ctx.tx.nonce, code)
    if status != 1:
        return 0, b""
    ctx.emit(DEPLOY_ADDRESS, b"deployed" + addr)
    return 1, addr


# ---------------------------------------------------------------------------
# Native token (reference NativeTokenContract.cs, LRC-20 surface)
# ---------------------------------------------------------------------------


def native_token(ctx: SystemContractContext, sel: bytes, args: Reader) -> Tuple[int, bytes]:
    if sel == SEL_TOTAL_SUPPLY:
        # supply = sum of genesis allocations + staking rewards; tracked key
        raw = ctx.sget(NATIVE_TOKEN_ADDRESS, b"supply")
        return 1, raw or write_u256(0)
    if sel == SEL_BALANCE_OF:
        addr = args.raw(ADDRESS_BYTES)
        return 1, write_u256(execution.get_balance(ctx.snap, addr))
    if sel == SEL_TRANSFER:
        to = args.raw(ADDRESS_BYTES)
        amount = args.u256()
        bal = execution.get_balance(ctx.snap, ctx.sender)
        if bal < amount:
            return 0, b""
        execution.set_balance(ctx.snap, ctx.sender, bal - amount)
        execution.set_balance(
            ctx.snap, to, execution.get_balance(ctx.snap, to) + amount
        )
        ctx.emit(NATIVE_TOKEN_ADDRESS, b"transfer" + ctx.sender + to + write_u256(amount))
        return 1, write_u256(1)
    return 0, b""


# ---------------------------------------------------------------------------
# Staking (reference StakingContract.cs): stake lifecycle + VRF lottery
# ---------------------------------------------------------------------------


def _stakers_key() -> bytes:
    return b"stakers"


def _get_staker_list(ctx) -> List[bytes]:
    raw = ctx.sget(STAKING_ADDRESS, _stakers_key())
    if not raw:
        return []
    r = Reader(raw)
    return r.bytes_list()


def _put_staker_list(ctx, stakers: List[bytes]) -> None:
    from ..utils.serialization import write_bytes_list

    ctx.sput(STAKING_ADDRESS, _stakers_key(), write_bytes_list(stakers))


def staking(ctx: SystemContractContext, sel: bytes, args: Reader) -> Tuple[int, bytes]:
    if sel == SEL_BECOME_STAKER:
        pubkey = args.bytes_()  # validator ECDSA pubkey
        amount = args.u256()
        if len(pubkey) != 33 or amount <= 0:
            return 0, b""
        bal = execution.get_balance(ctx.snap, ctx.sender)
        if bal < amount:
            return 0, b""
        execution.set_balance(ctx.snap, ctx.sender, bal - amount)
        prev = ctx.sget(STAKING_ADDRESS, b"stake:" + ctx.sender)
        prev_amount = int.from_bytes(prev, "big") if prev else 0
        ctx.sput(
            STAKING_ADDRESS, b"stake:" + ctx.sender, write_u256(prev_amount + amount)
        )
        ctx.sput(STAKING_ADDRESS, b"pub:" + ctx.sender, pubkey)
        stakers = _get_staker_list(ctx)
        if ctx.sender not in stakers:
            stakers.append(ctx.sender)
            _put_staker_list(ctx, stakers)
        total = ctx.sget(STAKING_ADDRESS, b"total")
        total_amount = int.from_bytes(total, "big") if total else 0
        ctx.sput(STAKING_ADDRESS, b"total", write_u256(total_amount + amount))
        ctx.emit(STAKING_ADDRESS, b"staked" + ctx.sender + write_u256(amount))
        return 1, b""

    if sel == SEL_GET_STAKE:
        addr = args.raw(ADDRESS_BYTES)
        raw = ctx.sget(STAKING_ADDRESS, b"stake:" + addr)
        return 1, raw or write_u256(0)

    if sel == SEL_REQUEST_WITHDRAW:
        # withdrawal queued; paid out at the cycle boundary (reference's
        # two-phase withdrawal, StakingContract withdrawal flow)
        raw = ctx.sget(STAKING_ADDRESS, b"stake:" + ctx.sender)
        if not raw or int.from_bytes(raw, "big") == 0:
            return 0, b""
        ctx.sput(STAKING_ADDRESS, b"withdraw:" + ctx.sender, raw)
        return 1, b""

    if sel == SEL_WITHDRAW:
        raw = ctx.sget(STAKING_ADDRESS, b"withdraw:" + ctx.sender)
        if not raw:
            return 0, b""
        amount = int.from_bytes(raw, "big")
        stake_raw = ctx.sget(STAKING_ADDRESS, b"stake:" + ctx.sender)
        stake_amount = int.from_bytes(stake_raw, "big") if stake_raw else 0
        pay = min(amount, stake_amount)
        if pay == 0:
            return 0, b""
        # accrued attendance penalties burn out of the unstaked amount
        # first (reference deducts _stakedAddressToPenalty from the
        # withdrawal, StakingContract.cs:396-448): the full `pay` leaves the
        # stake, only `credit` reaches the balance, `burn` is destroyed
        pen_key = b"penalty:" + ctx.sender
        penalty = int.from_bytes(ctx.sget(STAKING_ADDRESS, pen_key) or b"", "big")
        burn = min(penalty, pay)
        credit = pay - burn
        if burn:
            penalty -= burn
            if penalty:
                ctx.sput(STAKING_ADDRESS, pen_key, write_u256(penalty))
            else:
                ctx.sdel(STAKING_ADDRESS, pen_key)
            ctx.emit(
                STAKING_ADDRESS, b"penalty_burned" + ctx.sender + write_u256(burn)
            )
        ctx.sput(STAKING_ADDRESS, b"stake:" + ctx.sender, write_u256(stake_amount - pay))
        ctx.sdel(STAKING_ADDRESS, b"withdraw:" + ctx.sender)
        total = int.from_bytes(ctx.sget(STAKING_ADDRESS, b"total") or b"", "big") if ctx.sget(STAKING_ADDRESS, b"total") else 0
        ctx.sput(STAKING_ADDRESS, b"total", write_u256(max(total - pay, 0)))
        execution.set_balance(
            ctx.snap,
            ctx.sender,
            execution.get_balance(ctx.snap, ctx.sender) + credit,
        )
        ctx.emit(STAKING_ADDRESS, b"withdrawn" + ctx.sender + write_u256(credit))
        return 1, b""

    if sel == SEL_SUBMIT_ATTENDANCE:
        # (reference SubmitAttendanceDetection, StakingContract.cs:538-634):
        # during the first ATTENDANCE_DETECTION_DURATION blocks of a cycle,
        # each previous-cycle validator reports how many blocks it saw every
        # previous-cycle validator co-sign. Reports are votes; the median is
        # taken at finishAttendanceDetection. Checking in at all is what
        # shields a validator from the no-show penalty.
        cycle = ctx.block // CYCLE_DURATION
        if cycle == 0 or ctx.block % CYCLE_DURATION >= ATTENDANCE_DETECTION_DURATION:
            return 0, b""
        entries = args.bytes_list()
        prev_raw = ctx.sget(STAKING_ADDRESS, b"prev_pubs")
        prev_pubs = Reader(prev_raw).bytes_list() if prev_raw else []
        sender_pub = ctx.sget(STAKING_ADDRESS, b"pub:" + ctx.sender)
        if not sender_pub or sender_pub not in prev_pubs:
            return 0, b""
        checkin_key = b"att_checkin:" + write_u64(cycle)
        raw = ctx.sget(STAKING_ADDRESS, checkin_key)
        voters = Reader(raw).bytes_list() if raw else []
        if sender_pub in voters:
            return 0, b""
        # validate the whole report before accepting any of it; duplicate
        # targets are rejected — one voter gets ONE vote per validator, or
        # a single report could stuff the median
        parsed = []
        seen: set = set()
        for e in entries:
            if len(e) != 33 + 4:
                return 0, b""
            pub, cnt = e[:33], int.from_bytes(e[33:], "big")
            if pub not in prev_pubs or pub in seen or cnt > CYCLE_DURATION:
                return 0, b""
            seen.add(pub)
            parsed.append((pub, cnt))
        voters.append(sender_pub)
        from ..utils.serialization import write_bytes_list

        ctx.sput(STAKING_ADDRESS, checkin_key, write_bytes_list(voters))
        for pub, cnt in parsed:
            vkey = b"att_votes:" + write_u64(cycle) + pub
            ctx.sput(
                STAKING_ADDRESS,
                vkey,
                (ctx.sget(STAKING_ADDRESS, vkey) or b"") + write_u32(cnt),
            )
        ctx.emit(STAKING_ADDRESS, b"attendance_submitted" + sender_pub)
        return 1, b""

    if sel == SEL_FINISH_ATTENDANCE:
        # (reference DistributeRewardsAndPenalties, StakingContract.cs:
        # 656-720): once the detection window closes, each previous-cycle
        # validator's reward share scales with the MEDIAN voted block count;
        # a validator that never checked in forfeits its share and accrues
        # it as a penalty against its stake. Idempotent per cycle; any
        # validator may send the close tx once the window has passed (the
        # reference injects it as a block-production system tx instead).
        # A cycle whose close tx never landed before the cycle ended is
        # settled LAZILY here: any later finish first sweeps unsettled
        # prior cycles (their electorate snapshotted at rotation, see
        # SEL_FINISH_CYCLE) so rewards/penalties are never silently lost.
        cycle = ctx.block // CYCLE_DURATION
        if cycle == 0 or ctx.block % CYCLE_DURATION < ATTENDANCE_DETECTION_DURATION:
            return 0, b""
        # `att_settled` is the high-water mark of settled cycles: any cycle
        # above it is unsettled EVEN IF it left no state behind (a fully
        # stalled cycle with zero check-ins must still hand out no-show
        # penalties). Chains predating the watermark fall back to the
        # evidence gate for the one-time transition, since their settled
        # cycles cleaned up their done flags.
        wm_raw = ctx.sget(STAKING_ADDRESS, b"att_settled")
        watermark = int.from_bytes(wm_raw, "big") if wm_raw else None
        settled = 0
        high = watermark or 0
        lo = max(1, cycle - ATTENDANCE_SETTLE_LOOKBACK + 1)
        for x in range(lo, cycle):
            if ctx.sget(STAKING_ADDRESS, b"att_done:" + write_u64(x)):
                continue
            if watermark is not None:
                if x <= watermark:
                    continue
            elif not (
                ctx.sget(STAKING_ADDRESS, b"att_checkin:" + write_u64(x))
                or ctx.sget(STAKING_ADDRESS, b"att_pubs:" + write_u64(x))
            ):
                continue
            if _settle_attendance_cycle(ctx, x):
                settled += 1
                high = max(high, x)
        if not ctx.sget(STAKING_ADDRESS, b"att_done:" + write_u64(cycle)):
            if _settle_attendance_cycle(ctx, cycle):
                settled += 1
                high = cycle
        if settled and high > (watermark or 0):
            ctx.sput(STAKING_ADDRESS, b"att_settled", write_u64(high))
        return (1, b"") if settled else (0, b"")

    if sel == SEL_GET_PENALTY:
        addr = args.raw(ADDRESS_BYTES)
        raw = ctx.sget(STAKING_ADDRESS, b"penalty:" + addr)
        return 1, raw or write_u256(0)

    if sel == SEL_SUBMIT_VRF:
        # (reference SubmitVrf, StakingContract.cs:458-537): within the VRF
        # phase, a staker proves a winning lottery roll for the next cycle
        if ctx.block % CYCLE_DURATION >= VRF_SUBMISSION_PHASE:
            return 0, b""
        pubkey = args.bytes_()
        proof = args.bytes_()
        stored_pub = ctx.sget(STAKING_ADDRESS, b"pub:" + ctx.sender)
        if stored_pub != pubkey:
            return 0, b""
        stake_raw = ctx.sget(STAKING_ADDRESS, b"stake:" + ctx.sender)
        stake_amount = int.from_bytes(stake_raw, "big") if stake_raw else 0
        if stake_amount == 0:
            return 0, b""
        total_raw = ctx.sget(STAKING_ADDRESS, b"total")
        total = int.from_bytes(total_raw, "big") if total_raw else 0
        cycle = ctx.block // CYCLE_DURATION
        seed = ctx.sget(STAKING_ADDRESS, b"seed") or b"genesis-seed"
        alpha = seed + write_u64(cycle)
        if not vrf.verify(pubkey, alpha, proof):
            return 0, b""
        beta = vrf.proof_to_hash(proof)
        expected = int.from_bytes(
            ctx.sget(STAKING_ADDRESS, b"validators_count") or write_u32(7), "big"
        )
        if not vrf.is_winner(beta, stake_amount, total, expected):
            return 0, b""
        # record the winner for the cycle
        key = b"winner:" + write_u64(cycle) + ctx.sender
        if ctx.sget(STAKING_ADDRESS, key) is not None:
            return 0, b""  # duplicate submission
        ctx.sput(STAKING_ADDRESS, key, pubkey + beta)
        winners = _get_winner_list(ctx, cycle)
        winners.append(ctx.sender)
        _put_winner_list(ctx, cycle, winners)
        ctx.emit(STAKING_ADDRESS, b"vrf" + ctx.sender)
        return 1, b""

    if sel == SEL_FINISH_LOTTERY:
        # (reference FinishVrfLottery, StakingContract.cs:738-747): close the
        # phase, pick the next validator set from the winners. Only valid
        # once per cycle, after the submission phase has ended — otherwise
        # anyone could reroll the seed mid-phase and grind the election.
        cycle = ctx.block // CYCLE_DURATION
        if ctx.block % CYCLE_DURATION < VRF_SUBMISSION_PHASE:
            return 0, b""
        if ctx.sget(STAKING_ADDRESS, b"lottery_done:" + write_u64(cycle)):
            return 0, b""
        winners = _get_winner_list(ctx, cycle)
        pubs = []
        for w in winners:
            rec = ctx.sget(STAKING_ADDRESS, b"winner:" + write_u64(cycle) + w)
            if rec:
                pubs.append(rec[:33])
        if pubs:
            from ..utils.serialization import write_bytes_list

            ctx.sput(STAKING_ADDRESS, b"lottery_done:" + write_u64(cycle), b"\x01")
            ctx.sput(
                STAKING_ADDRESS,
                b"next_validators",
                write_bytes_list(pubs),
            )
            # roll the seed forward
            ctx.sput(
                STAKING_ADDRESS,
                b"seed",
                keccak256_host((ctx.sget(STAKING_ADDRESS, b"seed") or b"") + write_u64(cycle)),
            )
            ctx.emit(STAKING_ADDRESS, b"lottery_done" + write_u64(cycle))
            return 1, b""
        return 0, b""

    return 0, b""


def _settle_attendance_cycle(ctx: SystemContractContext, x: int) -> int:
    """Distribute cycle `x`'s attendance rewards/penalties (reference
    DistributeRewardsAndPenalties, StakingContract.cs:656-720) and clean its
    per-cycle state. Electorate: the rotation-time snapshot `att_pubs:x` if
    the validator set changed since, else the live prev_pubs. Returns 1 if
    settled, 0 if there was no electorate to settle against."""
    cyc = write_u64(x)
    pubs_raw = ctx.sget(STAKING_ADDRESS, b"att_pubs:" + cyc) or ctx.sget(
        STAKING_ADDRESS, b"prev_pubs"
    )
    prev_pubs = Reader(pubs_raw).bytes_list() if pubs_raw else []
    if not prev_pubs:
        return 0
    ctx.sput(STAKING_ADDRESS, b"att_done:" + cyc, b"\x01")
    raw = ctx.sget(STAKING_ADDRESS, b"att_checkin:" + cyc)
    voters = Reader(raw).bytes_list() if raw else []
    max_share = ATTENDANCE_CYCLE_REWARD // len(prev_pubs)
    from ..crypto.ecdsa import address_from_public_key

    for pub in prev_pubs:
        addr = address_from_public_key(pub)
        pen_key = b"penalty:" + addr
        penalty = int.from_bytes(
            ctx.sget(STAKING_ADDRESS, pen_key) or b"", "big"
        )
        if pub not in voters:
            penalty += max_share  # no-show: reward-sized penalty
        vkey = b"att_votes:" + cyc + pub
        votes_raw = ctx.sget(STAKING_ADDRESS, vkey) or b""
        votes = sorted(
            int.from_bytes(votes_raw[i : i + 4], "big")
            for i in range(0, len(votes_raw), 4)
        )
        if votes:
            mid = len(votes) // 2
            active = (
                (votes[mid - 1] + votes[mid]) // 2
                if len(votes) % 2 == 0
                else votes[mid]
            )
        else:
            active = 0
        reward = max_share * active // CYCLE_DURATION
        burn = min(penalty, reward)
        penalty -= burn
        reward -= burn
        if penalty:
            ctx.sput(STAKING_ADDRESS, pen_key, write_u256(penalty))
        else:
            ctx.sdel(STAKING_ADDRESS, pen_key)
        if reward:
            execution.set_balance(
                ctx.snap,
                addr,
                execution.get_balance(ctx.snap, addr) + reward,
            )
        ctx.sdel(STAKING_ADDRESS, vkey)
    # settle-time cleanup (reference ClearAttendanceDetectorCheckIns); the
    # done flag itself is kept for ATTENDANCE_SETTLE_LOOKBACK cycles so the
    # lazy sweep can tell "settled" from "orphaned", then swept
    ctx.sdel(STAKING_ADDRESS, b"att_checkin:" + cyc)
    ctx.sdel(STAKING_ADDRESS, b"att_pubs:" + cyc)
    if x > ATTENDANCE_SETTLE_LOOKBACK:
        ctx.sdel(
            STAKING_ADDRESS,
            b"att_done:" + write_u64(x - ATTENDANCE_SETTLE_LOOKBACK),
        )
    ctx.emit(STAKING_ADDRESS, b"attendance_finished" + cyc)
    return 1


def _get_winner_list(ctx, cycle: int) -> List[bytes]:
    raw = ctx.sget(STAKING_ADDRESS, b"winners:" + write_u64(cycle))
    if not raw:
        return []
    return Reader(raw).bytes_list()


def _put_winner_list(ctx, cycle: int, winners: List[bytes]) -> None:
    from ..utils.serialization import write_bytes_list

    ctx.sput(
        STAKING_ADDRESS, b"winners:" + write_u64(cycle), write_bytes_list(winners)
    )


# ---------------------------------------------------------------------------
# Governance (reference GovernanceContract.cs): keygen tx lifecycle + the
# validator-set change. The DKG math itself lives in consensus/keygen.py;
# these methods are the on-chain message board the keygen rides on.
# ---------------------------------------------------------------------------


def _is_next_validator(ctx: SystemContractContext) -> bool:
    """Sender gating for the keygen message board: only addresses of the
    LOTTERY-ELECTED set may post (reference GovernanceContract keygen
    methods check the sender against the cycle's validator set,
    GovernanceContract.cs:117-217). Without this, any funded address could
    sybil n-f confirms and install an attacker validator set."""
    from ..crypto import ecdsa as _ecdsa

    nv_raw = ctx.sget(STAKING_ADDRESS, b"next_validators")
    if not nv_raw:
        return False
    for pub in Reader(nv_raw).bytes_list():
        if _ecdsa.address_from_public_key(pub) == ctx.sender:
            return True
    return False


def governance(ctx: SystemContractContext, sel: bytes, args: Reader) -> Tuple[int, bytes]:
    if sel == SEL_KEYGEN_COMMIT:
        if not _is_next_validator(ctx):
            return 0, b""
        blob = args.bytes_()
        key = b"commit:" + write_u64(ctx.block // CYCLE_DURATION) + ctx.sender
        ctx.sput(GOVERNANCE_ADDRESS, key, blob)
        ctx.emit(GOVERNANCE_ADDRESS, b"keygen_commit" + ctx.sender + blob)
        return 1, b""
    if sel == SEL_KEYGEN_SEND_VALUE:
        if not _is_next_validator(ctx):
            return 0, b""
        round_no = args.u256()
        blob = args.bytes_()
        key = (
            b"value:"
            + write_u64(ctx.block // CYCLE_DURATION)
            + write_u64(round_no & 0xFFFFFFFFFFFFFFFF)
            + ctx.sender
        )
        ctx.sput(GOVERNANCE_ADDRESS, key, blob)
        ctx.emit(GOVERNANCE_ADDRESS, b"keygen_value" + ctx.sender + blob)
        return 1, b""
    if sel == SEL_KEYGEN_CONFIRM:
        if not _is_next_validator(ctx):
            return 0, b""
        blob = args.bytes_()  # serialized new public key set
        cycle = ctx.block // CYCLE_DURATION
        h = keccak256_host(blob)
        cnt_key = b"confirms:" + write_u64(cycle) + h
        raw = ctx.sget(GOVERNANCE_ADDRESS, cnt_key)
        voters = Reader(raw).bytes_list() if raw else []
        if ctx.sender in voters:
            return 0, b""
        voters.append(ctx.sender)
        from ..utils.serialization import write_bytes_list

        ctx.sput(GOVERNANCE_ADDRESS, cnt_key, write_bytes_list(voters))
        ctx.sput(GOVERNANCE_ADDRESS, b"candidate:" + h, blob)
        ctx.emit(GOVERNANCE_ADDRESS, b"keygen_confirm" + ctx.sender)
        # N-F matching confirms from the elected set finalize the rotation
        # (reference GovernanceContract.Confirm -> ChangeValidators,
        # GovernanceContract.cs:283-331)
        nv_raw = ctx.sget(STAKING_ADDRESS, b"next_validators")
        if nv_raw:
            n_next = len(Reader(nv_raw).bytes_list())
            f_next = (n_next - 1) // 3
            if len(voters) >= n_next - f_next:
                ctx.sput(GOVERNANCE_ADDRESS, b"pending_validators", blob)
                ctx.emit(GOVERNANCE_ADDRESS, b"validators_changed" + h)
        return 1, write_u32(len(voters))
    if sel == SEL_CHANGE_VALIDATORS:
        # In the reference this is an internal transition invoked by the
        # confirm threshold (GovernanceContract.cs:283-331), never a public
        # entry point; exposing it lets one funded address install an
        # arbitrary validator set. The only path to pending_validators is
        # the n-f keygen-confirm quorum above.
        return 0, b""
    if sel == SEL_FINISH_CYCLE:
        # only the cycle's LAST block may rotate the set: the new keys are
        # wallet-installed from era (cycle+1)*CYCLE_DURATION, so the
        # validator-set flip must land in the snapshot of exactly the block
        # before (reference injects FinishCycle as a cycle-boundary system
        # tx, BlockProducer.cs:126-146)
        if ctx.block % CYCLE_DURATION != CYCLE_DURATION - 1:
            return 0, b""
        pending = ctx.sget(GOVERNANCE_ADDRESS, b"pending_validators")
        if pending:
            outgoing = ctx.snap.get("validators", b"current")
            ctx.snap.put("validators", b"current", pending)
            ctx.sdel(GOVERNANCE_ADDRESS, b"pending_validators")
            # next cycle's attendance-detection electorate is the OUTGOING
            # set — the validators who served the cycle being judged
            # (reference captures _previousValidatorPubKeys from the
            # pre-rotation snapshot). When the genesis set was still active
            # (`outgoing` is None) prev_pubs already holds it. The NEW
            # set's pub->address mappings register now so its members can
            # submit once they become the electorate.
            try:
                from ..consensus.keys import PublicConsensusKeys
                from ..crypto.ecdsa import address_from_public_key
                from ..utils.serialization import write_bytes_list

                if outgoing is not None:
                    # preserve the electorate of any cycle whose attendance
                    # close tx hasn't landed yet: once prev_pubs rotates,
                    # a lazy finishAttendanceDetection for those cycles
                    # needs the set they actually voted with
                    cyc_now = ctx.block // CYCLE_DURATION
                    prev_raw = ctx.sget(STAKING_ADDRESS, b"prev_pubs")
                    wm_raw = ctx.sget(STAKING_ADDRESS, b"att_settled")
                    wm = int.from_bytes(wm_raw, "big") if wm_raw else None
                    if prev_raw is not None:
                        for x in range(
                            max(1, cyc_now - ATTENDANCE_SETTLE_LOOKBACK + 1),
                            cyc_now + 1,
                        ):
                            cyc_key = write_u64(x)
                            if ctx.sget(
                                STAKING_ADDRESS, b"att_done:" + cyc_key
                            ) or ctx.sget(
                                STAKING_ADDRESS, b"att_pubs:" + cyc_key
                            ):
                                continue
                            if wm is not None:
                                if x <= wm:
                                    continue  # settled pre-cleanup
                            elif x != cyc_now and not ctx.sget(
                                STAKING_ADDRESS, b"att_checkin:" + cyc_key
                            ):
                                continue  # pre-watermark transition
                            ctx.sput(
                                STAKING_ADDRESS,
                                b"att_pubs:" + cyc_key,
                                prev_raw,
                            )
                    out_keys = PublicConsensusKeys.decode(outgoing)
                    ctx.sput(
                        STAKING_ADDRESS,
                        b"prev_pubs",
                        write_bytes_list(list(out_keys.ecdsa_pub_keys)),
                    )
                new_keys = PublicConsensusKeys.decode(pending)
                for pub in new_keys.ecdsa_pub_keys:
                    ctx.sput(
                        STAKING_ADDRESS,
                        b"pub:" + address_from_public_key(pub),
                        pub,
                    )
            except Exception:
                pass  # undecodable candidate cannot block the rotation
            ctx.emit(GOVERNANCE_ADDRESS, b"cycle_finished")
            return 1, b""
        return 0, b""
    return 0, b""


# ---------------------------------------------------------------------------
# Registry / dispatcher (reference ContractRegisterer.cs)
# ---------------------------------------------------------------------------


def dispatch(
    snap: Snapshot,
    sender: bytes,
    tx: Transaction,
    block: int,
    tx_hash: Optional[bytes] = None,
) -> Tuple[int, bytes]:
    ctx = SystemContractContext(snap, sender, tx, block)
    data = tx.invocation
    if len(data) < 4:
        return 0, b""
    sel, rest = data[:4], Reader(data[4:])
    try:
        if tx.to == DEPLOY_ADDRESS and sel == SEL_DEPLOY:
            result = deploy_contract(ctx, rest)
        elif tx.to == NATIVE_TOKEN_ADDRESS:
            result = native_token(ctx, sel, rest)
        elif tx.to == STAKING_ADDRESS:
            result = staking(ctx, sel, rest)
        elif tx.to == GOVERNANCE_ADDRESS:
            result = governance(ctx, sel, rest)
        else:
            return 0, b""
    except (ValueError, AssertionError):
        return 0, b""
    # persist emitted events so node services (KeyGenManager) can react to
    # executed system txs (reference: BlockManager.OnSystemContractInvoked,
    # BlockManager.cs:171-176, 547-560)
    if result[0] == 1 and tx_hash is not None:
        from ..utils.serialization import write_u32 as _u32

        for i, (contract, payload) in enumerate(ctx.events):
            snap.put("events", tx_hash + _u32(i), contract + payload)
    return result


SYSTEM_CONTRACTS: Dict[bytes, Callable] = {
    addr: dispatch
    for addr in (
        DEPLOY_ADDRESS,
        NATIVE_TOKEN_ADDRESS,
        GOVERNANCE_ADDRESS,
        STAKING_ADDRESS,
    )
}


def register_genesis_validators(snap: Snapshot, pubkeys: List[bytes]) -> None:
    """Seed the attendance-detection electorate at genesis: the staking
    contract's `prev_pubs` list plus the pub->address mapping for each
    genesis validator (a rotation later overwrites both at FinishCycle).
    Reference analogue: genesis validators enter _previousValidatorPubKeys
    via config, config_mainnet.json validators."""
    from ..crypto.ecdsa import address_from_public_key
    from ..utils.serialization import write_bytes_list

    snap.put(
        "storage",
        _skey(STAKING_ADDRESS, b"prev_pubs"),
        write_bytes_list(list(pubkeys)),
    )
    for pub in pubkeys:
        snap.put(
            "storage",
            _skey(STAKING_ADDRESS, b"pub:" + address_from_public_key(pub)),
            pub,
        )


def make_executer(chain_id: int) -> execution.TransactionExecuter:
    """TransactionExecuter wired with the system-contract registry."""
    return execution.TransactionExecuter(
        chain_id,
        system_contracts=dict(SYSTEM_CONTRACTS),
    )
