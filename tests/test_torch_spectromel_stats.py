"""The spectromel stats launch's layout and order of work, on the CPU.

`stats_plan` (ops/spectromel.py) lays out csrc/spectromel.cu's
`spectromel_stats`: a cluster of `cs` blocks per clip, each owning a
contiguous range of its valid frames and transforming those frames with the
rows their deltas read (`StatsPlan.window`).  The plan is held here at
every bucket and hop the kernels take.  `emulate_stats` repeats the
kernel's order of work in NumPy -- each block's max over its valid mel
rows, the floor as the max of those maxima, each block's DCT of its own
window of clamped rows and its deltas from those, then each column's mean
and centred std in the one-block kernel's order (lane l of a warp over
frames l, l + 32, ..., then the warp's xor tree) -- and is held
to `spectromel_plain` and to the Pallas kernel in interpret mode within the
bounds tests/test_pallas.py sets for the MFCC statistics (max error 2e-3,
mean error 2e-4), and to the plain version within 1e-5 of its largest
statistic as well (both FP32, summed in other orders).  On the card
tests/test_torch_cuda.py holds the kernel itself to the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stutter_tpu_torch.ops import filterbanks as fb
from stutter_tpu_torch.ops.consts import savgol_taps
from stutter_tpu_torch.ops.spectromel import (
    MAX_CLUSTER,
    SMEM_LIMIT,
    StatsPlan,
    stats_plan,
    stats_smem_bytes,
)

torch.set_num_threads(2)

HOP = 512
N = 24576  # the 1.5 s bucket: T = 49
BUCKETS = (49152, 98304, 163840)  # 3 s, 5 s and 10.1 s
# the hops of n_fft 2048, 1024 and 512 at a quarter of n_fft, and of the
# other n_fft / hop ratios the kernel takes (tests/test_torch_cuda.py)
HOPS = (512, 256, 128, 64)
# n_valid cases: one frame, under and at the SavGol width, the whole
# bucket, and 21, which ends on a block boundary of the kernel's own plan
# for these 7 clips (7 blocks of 7 frames)
N_VALID = (1, 5, 8, 9, 10, 49, 21)


@pytest.mark.parametrize("B", [1, 64, 256])
@pytest.mark.parametrize("hop", HOPS)
@pytest.mark.parametrize("N_bucket", BUCKETS)
def test_stats_plan_covers_every_needed_frame_once(N_bucket, hop, B):
    T = N_bucket // hop + 1
    plan = stats_plan(B, T)
    assert 1 <= plan.cs <= MAX_CLUSTER
    assert plan.smem == stats_smem_bytes(plan.rows) <= SMEM_LIMIT
    assert plan.cs * plan.rows >= T
    for nv in sorted({1, 5, 8, 9, 10, T // 3, plan.rows, T - 1, T}):
        need = min(max(nv, 9), T)
        owners, read = np.zeros(T, np.int64), np.zeros(T, bool)
        for q, (start, end) in enumerate(plan.ranges(nv, T)):
            assert 0 <= start <= end <= nv and end - start <= plan.rows
            owners[start:end] += 1
            lo, hi = plan.window(q, nv, T)
            if start == end:  # a block without valid frames reads no row
                assert lo == hi
                continue
            assert 0 <= lo <= hi <= need and hi - lo <= plan.rows + 12
            read[lo:hi] = True
        # every valid frame in exactly one block, and the frames the blocks
        # transform reach max(nv, 9) and no further
        assert (owners[:nv] == 1).all() and (owners[nv:] == 0).all()
        assert read[:need].all() and not read[need:].any()


def test_stats_plan_spreads_a_request_and_fills_a_batch():
    # one 3 s request over 8 blocks; a batch of 256 at a block a clip, 64 at 2
    assert stats_plan(1, 97) == StatsPlan(8, 13, stats_smem_bytes(13))
    assert stats_plan(256, 97) == StatsPlan(1, 97, stats_smem_bytes(97))
    assert stats_plan(64, 95).cs == 2
    # a short bucket keeps 8 frames a block
    assert stats_plan(1, 20) == StatsPlan(3, 7, stats_smem_bytes(7))


def test_stats_plan_refuses_what_the_launch_cannot_take():
    with pytest.raises(ValueError):  # under the SavGol width
        stats_plan(1, 8)
    with pytest.raises(ValueError):  # a mel row is read in 16-byte units
        stats_plan(1, 97, n_mels=126)
    with pytest.raises(ValueError):  # 8 blocks' shared memory cannot hold the frames
        stats_plan(1, 4000)
    # the largest bucket at the smallest hop takes more blocks than the batch asks for
    assert stats_plan(256, 163840 // 64 + 1).cs == MAX_CLUSTER


def _delta_rows(t: int, nv: int) -> range:
    """The MFCC rows the SavGol rows of frame t < nv read."""
    if 0 <= t - (nv - 4) < 4:  # last edge
        return range(max(nv - 9, 0), max(nv - 9, 0) + 9)
    return range(0, 9) if t < 4 else range(t - 4, t + 5)


@pytest.mark.parametrize("T", [9, 20, 49])
def test_block_window_holds_every_row_its_deltas_read(T):
    """The frames [lo, hi) a block transforms hold every MFCC row its valid
    frames' SavGol rows read, at every block size and n_valid of a bucket."""
    for rows in range(1, T + 1):
        plan = StatsPlan(-(-T // rows), rows, stats_smem_bytes(rows))
        for nv in range(1, T + 1):
            for q, (start, end) in enumerate(plan.ranges(nv, T)):
                lo, hi = plan.window(q, nv, T)
                for t in range(start, end):
                    read = _delta_rows(t, nv)
                    assert lo <= read.start and read.stop <= hi, (rows, nv, t)


def _xor_tree(lanes: np.ndarray) -> np.float32:
    """A warp's xor-shuffle sum of 32 float32 lane values (every lane ends
    with the same bits; lane 0's)."""
    v = lanes.astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ o]
    return v[0]


def emulate_stats(db: np.ndarray, n_valid: np.ndarray, plan: StatsPlan,
                  n_mfcc: int = 20) -> np.ndarray:
    """[B, T, M] dB mel (launch 1's stats-mode output) -> [B, 6, n_mfcc], in
    spectromel_stats' order of work, in float32."""
    B, T, M = db.shape
    C = n_mfcc
    dct = fb.dct_mat(C, M).T.astype(np.float32)  # [M, C]
    taps = savgol_taps()  # [2, 9, 9]
    out = np.zeros((B, 6, C), np.float32)
    for b in range(B):
        nv = min(int(n_valid[b]), T)
        ranges = plan.ranges(nv, T)
        maxima = [db[b, s:e].max() if e > s else -np.inf for s, e in ranges]
        floor = np.float32(max(maxima) - np.float32(80.0))
        start = max(nv - 9, 0)
        values = np.zeros((nv, 3 * C), np.float32)  # each frame's, from the block that owns it
        for q, (s, e) in enumerate(ranges):
            lo, hi = plan.window(q, nv, T)
            mf = np.maximum(db[b, lo:hi], floor) @ dct  # the block's own DCT of its rows
            for t in range(s, e):
                edge = t - (nv - 4)
                if 0 <= edge < 4:  # last edge, at the clip's own n_valid
                    s0, row = start, 5 + edge
                elif t < 4:  # first edge
                    s0, row = 0, 1 + t
                else:  # interior
                    s0, row = t - 4, 0
                w = mf[s0 - lo:s0 - lo + 9]
                values[t] = np.concatenate([mf[t - lo], taps[0, row] @ w, taps[1, row] @ w])
        # per column, lane l sums frames l, l + 32, ... in order, then the
        # warp's xor tree; the centred squares the same way
        cnt = np.float32(max(nv, 1))
        for col in range(3 * C):
            x = values[:, col]
            lanes = np.zeros(32, np.float32)
            for t in range(nv):
                lanes[t % 32] += x[t]
            mean = _xor_tree(lanes) / cnt
            lanes[:] = 0
            for t in range(nv):
                lanes[t % 32] += (x[t] - mean) * (x[t] - mean)
            k, c = divmod(col, C)
            out[b, 2 * k, c] = mean
            out[b, 2 * k + 1, c] = np.sqrt(_xor_tree(lanes) / cnt)
    return out


@pytest.fixture(scope="module")
def stats_case():
    """7 clips of the 1.5 s bucket, one per n_valid case: the dB mel launch 1
    writes for them, and the stats of spectromel_plain and of the Pallas
    kernel in interpret mode."""
    from stutter_tpu.ops.pallas_spectromel import spectromel_pallas
    from stutter_tpu_torch.ops.masked import frame_mask
    from stutter_tpu_torch.ops.spectral import mel_filterbank, power_spectrogram
    from stutter_tpu_torch.ops.spectromel import spectromel_plain

    rng = np.random.RandomState(12)
    t = np.arange(N) / 16000.0
    audio = (0.1 * rng.randn(len(N_VALID), N)
             + 0.4 * np.sin(2 * np.pi * rng.uniform(100, 3000, (len(N_VALID), 1)) * t))
    lengths = np.array([(nv - 1) * HOP + (rng.randint(HOP) if nv < 49 else 0)
                        for nv in N_VALID], np.int32)
    for b, n in enumerate(lengths):
        audio[b, n:] = 0
    audio = audio.astype(np.float32)
    a, le = torch.from_numpy(audio), torch.from_numpy(lengths)
    power = power_spectrogram(a, 2048, HOP)
    power = torch.where(frame_mask(le, HOP, power.shape[1])[:, :, None], power, 0.0)
    mel = torch.matmul(power, mel_filterbank(16000, 2048, 128, "cpu").T)
    db = (10.0 * torch.log10(torch.clamp_min(mel, 1e-10))).numpy()
    plain = spectromel_plain(a, le)[1].numpy()
    pallas = np.asarray(spectromel_pallas(jnp.asarray(audio), jnp.asarray(lengths),
                                          with_tuning=True, with_stats=True, interpret=True)[1])
    return db, 1 + lengths // HOP, plain, pallas


def _within_bounds(got, ref):
    err = np.abs(got - ref)
    assert err.max() < 2e-3 and err.mean() < 2e-4, (err.max(), err.mean())


def test_cases_cover_the_listed_n_valid(stats_case):
    db, n_valid, _, _ = stats_case
    T = db.shape[1]
    assert tuple(n_valid) == N_VALID and T == 49
    plan = stats_plan(len(N_VALID), T)
    assert plan == StatsPlan(7, 7, stats_smem_bytes(7))
    assert 21 % plan.rows == 0  # a clip that ends on a block boundary


@pytest.mark.parametrize("plan", [
    None,  # the kernel's own plan for these clips
    StatsPlan(1, 49, stats_smem_bytes(49)),  # one block a clip
    StatsPlan(3, 17, stats_smem_bytes(17)),  # a last block of fewer frames
    StatsPlan(8, 7, stats_smem_bytes(7)),  # an empty last block
    StatsPlan(8, 8, stats_smem_bytes(8)),  # blocks under the SavGol width
], ids=["own", "cs1", "cs3", "cs8-empty", "cs8"])
@pytest.mark.parametrize("reference", ["plain", "pallas"])
def test_kernel_order_of_work_matches_references(stats_case, plan, reference):
    db, n_valid, plain, pallas = stats_case
    plan = plan or stats_plan(len(n_valid), db.shape[1])
    got = emulate_stats(db, n_valid, plan)
    ref = plain if reference == "plain" else pallas
    assert got.shape == ref.shape == (len(N_VALID), 6, 20)
    assert np.isfinite(got).all()
    _within_bounds(got, ref)
    for b in range(len(N_VALID)):  # every n_valid case on its own, n_valid < 9 included
        _within_bounds(got[b], ref[b])
    if reference == "plain":  # the same FP32 arithmetic in another order: far closer
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_kernel_order_of_work_gives_the_same_bits_at_every_plan(stats_case):
    """Each frame's DCT and deltas run alone and each column sums in a fixed
    order, so a clip's stats do not depend on how its frames are split
    among blocks: the same bits at every cluster size."""
    db, n_valid, _, _ = stats_case
    ref = emulate_stats(db, n_valid, StatsPlan(1, 49, stats_smem_bytes(49)))
    for cs, rows in ((2, 25), (3, 17), (7, 7), (8, 8)):
        np.testing.assert_array_equal(
            emulate_stats(db, n_valid, StatsPlan(cs, rows, stats_smem_bytes(rows))), ref)


def test_sg_delta_single_order_matches_jax():
    from stutter_tpu.ops.delta import sg_delta as j_sg_delta
    from stutter_tpu_torch.ops.delta import sg_delta, sg_deltas

    rng = np.random.RandomState(4)
    x = (rng.randn(3, 40, 13) * 50).astype(np.float32)
    n_valid = np.array([40, 9, 17], np.int32)
    valid = np.arange(40)[None, :] < n_valid[:, None]
    both = sg_deltas(torch.from_numpy(x), torch.from_numpy(n_valid))
    for order in (1, 2):
        ours = sg_delta(torch.from_numpy(x), torch.from_numpy(n_valid), order=order).numpy()
        theirs = np.asarray(j_sg_delta(jnp.asarray(x), jnp.asarray(n_valid), order=order))
        assert np.abs(ours - theirs)[valid].max() <= 1e-5 * np.abs(theirs[valid]).max()
        np.testing.assert_array_equal(ours, both[order - 1].numpy())


@pytest.mark.parametrize("source", ["spectral_gate.cu", "spectromel.cu", "chroma_stats.cu"])
def test_kernel_phase_switches_find_their_text(source):
    """tools/kernel_phases.py switches a phase off by the text of its loop
    or call; each text is in its source once, so a change to a kernel that
    moves the text fails here, not in a chip run."""
    from stutter_tpu_torch import _build
    from stutter_tpu_torch.tools.kernel_phases import PHASES

    text = (_build.CSRC / source).read_text()
    for phase, (old, new) in PHASES[source].items():
        assert text.count(old) == 1, phase
        assert "OFF" in new and "OFF" not in old, phase


def test_stats_timeline_stages_find_their_text():
    """tools/kernel_phases.py --stats-timeline stamps the clock after each
    stage's text in csrc/spectromel.cu; each text is there once."""
    from stutter_tpu_torch import _build
    from stutter_tpu_torch.tools.kernel_phases import STATS_STAGES, STATS_START

    text = (_build.CSRC / "spectromel.cu").read_text()
    for stage, anchor in (("start", STATS_START), *STATS_STAGES):
        assert text.count(anchor) == 1, stage
