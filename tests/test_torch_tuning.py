"""The tuning tail's compacted candidate layout, on the CPU: the plain
`compact_candidates` / `tuning_bin_from_compacted` (the layout and function
of the spectromel kernel's candidate epilogue and tuning tail) against the
uncompacted `tuning_bin_from_candidates` and the JAX package's
`tuning_bin_from_candidates` (compacted False and True), exactly.  Also:
the port's public entry points run on `cuda` unless asked for the CPU, so
on a host without a GPU each raises."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stutter_tpu_torch.ops.chroma import (
    compact_candidates,
    estimate_tuning_bin,
    keys_to_f32,
    ordered_keys,
    piptrack_candidates,
    tuning_bin_from_candidates,
    tuning_bin_from_compacted,
)

torch.set_num_threads(2)

W = 20  # band bins of the synthetic frames (the JAX 4->2 compaction needs W % 4 == 0)


def _frame(rng, n_cand, dense=False):
    """One frame's (mags, idxm) [W] with n_cand non-adjacent candidates."""
    mags, idxm = np.zeros(W, np.float32), np.full(W, -1.0, np.float32)
    pos = np.arange(0, W, 2) if dense else np.sort(rng.choice(np.arange(0, W, 2), n_cand, False))
    pos = pos + (0 if dense else rng.randint(2))
    mags[pos] = rng.choice([0.25, 0.5, 1.0, 2.0, 3.5], len(pos)).astype(np.float32) * (
        1 + rng.randint(0, 3, len(pos)) * np.float32(2.0 ** -20))
    idxm[pos] = rng.randint(0, 100, len(pos))
    return mags, idxm


def _cases():
    """[B, T, W] candidates: a clip with none, one with a single candidate,
    one with an even count whose middle values are equal, one with every
    frame at its densest (every other bin), and random clips."""
    rng = np.random.RandomState(31)
    T, clips = 4, []
    clips.append([(np.zeros(W, np.float32), np.full(W, -1.0, np.float32))] * T)
    one = [(np.zeros(W, np.float32), np.full(W, -1.0, np.float32)) for _ in range(T)]
    one[2][0][7], one[2][1][7] = 1.5, 42.0
    clips.append(one)
    even = [(np.zeros(W, np.float32), np.full(W, -1.0, np.float32)) for _ in range(T)]
    for t, (pos, mag, ix) in enumerate([(1, 1.0, 10.0), (5, 2.0, 60.0), (9, 2.0, 61.0),
                                        (13, 3.0, 60.0)]):
        even[t][0][pos], even[t][1][pos] = mag, ix
    clips.append(even)
    clips.append([_frame(rng, 0, dense=True) for _ in range(T)])
    for _ in range(4):
        clips.append([_frame(rng, rng.randint(0, W // 2 + 1)) for _ in range(T)])
    mags = np.stack([np.stack([m for m, _ in c]) for c in clips])
    idxm = np.stack([np.stack([i for _, i in c]) for c in clips])
    return mags, idxm


def test_compacted_tail_matches_uncompacted_and_jax_exactly():
    from stutter_tpu.ops.chroma import tuning_bin_from_candidates as j_tuning

    mags, idxm = _cases()
    keys, bins, counts = compact_candidates(torch.from_numpy(mags), torch.from_numpy(idxm))
    got = tuning_bin_from_compacted(keys, bins, counts).numpy()
    plain = tuning_bin_from_candidates(torch.from_numpy(mags), torch.from_numpy(idxm)).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, np.asarray(j_tuning(jnp.asarray(mags), jnp.asarray(idxm))))
    # the JAX package's compacted path on the same slots (empty: mag 0, bin -1)
    valid = (torch.arange(keys.shape[-1]) < counts[..., None]).numpy()
    mags_c = np.where(valid, keys_to_f32(keys).numpy(), 0.0).astype(np.float32)
    idx_c = np.where(valid, bins.numpy().astype(np.float32), np.float32(-1.0))
    np.testing.assert_array_equal(got, np.asarray(j_tuning(jnp.asarray(mags_c), jnp.asarray(idx_c),
                                                           compacted=True)))
    assert got[0] == 50 and got[1] == 42 and got[2] == 60  # none; one; ties at the median


def test_compact_candidates_layout():
    """Frame t's candidates in bin order in slots 0 .. count - 1 of cap =
    ceil(W / 2) slots, keys decoding to the magnitudes, bins as bytes; the
    densest frame fills every slot; adjacent candidates are refused."""
    mags, idxm = _cases()
    keys, bins, counts = compact_candidates(torch.from_numpy(mags), torch.from_numpy(idxm))
    B, T, _ = mags.shape
    assert keys.shape == bins.shape == (B, T, W // 2) and keys.dtype == torch.int32
    assert bins.dtype == torch.uint8 and counts.dtype == torch.int32
    for b in range(B):
        for t in range(T):
            pos = np.flatnonzero(idxm[b, t] >= 0)
            n = int(counts[b, t])
            assert n == len(pos)
            np.testing.assert_array_equal(keys_to_f32(keys[b, t, :n]).numpy(), mags[b, t, pos])
            np.testing.assert_array_equal(bins[b, t, :n].numpy(), idxm[b, t, pos])
            assert not keys[b, t, n:].any() and not bins[b, t, n:].any()
    assert (counts[3] == W // 2).all()  # the densest clip
    bad = np.full((1, 1, 4), -1.0, np.float32)
    bad[0, 0, :3] = 5.0
    with pytest.raises(ValueError):
        compact_candidates(torch.zeros(1, 1, 4), torch.from_numpy(bad))


def test_ordered_keys_preserve_order_and_round_trip():
    x = torch.tensor([-3.5, -1e-30, -0.0, 0.0, 1e-38, 0.25, 7.0, 3e38], dtype=torch.float32)
    k = ordered_keys(x)
    assert (k[1:] > k[:-1]).all() and int(k.min()) >= 0 and int(k.max()) < 2 ** 32
    back = keys_to_f32(k)
    assert torch.equal(back.view(torch.int32), x.view(torch.int32))  # -0.0 stays -0.0


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (512, 256)])
def test_compacted_tail_on_real_power(n_fft, hop):
    """On the plain spectromel's power (tones, noise, a silent clip): the
    compacted layout gives the plain estimate's bin in every clip."""
    from stutter_tpu_torch.ops.spectral import power_spectrogram

    rng = np.random.RandomState(32)
    t = np.arange(24576) / 16000
    audio = np.stack([0.4 * np.sin(2 * np.pi * 440.3 * t) + 0.05 * rng.randn(24576),
                      0.3 * rng.randn(24576), np.zeros(24576)]).astype(np.float32)
    power = power_spectrogram(torch.from_numpy(audio), n_fft, hop)
    mags, idxm = piptrack_candidates(power, 16000, n_fft)
    keys, bins, counts = compact_candidates(mags, idxm)
    assert keys.shape[-1] == (mags.shape[-1] + 1) // 2 and int(counts[2].sum()) == 0
    tb = tuning_bin_from_compacted(keys, bins, counts)
    assert torch.equal(tb, estimate_tuning_bin(power, 16000, n_fft)) and int(tb[2]) == 50


def _wav(tmp_path):
    from stutter_tpu_torch.io.wav import write_wav

    path = tmp_path / "c.wav"
    write_wav(path, np.zeros(4000, np.float32), 16000)
    return str(path)


def _mlp_params():
    return {"w0": np.zeros((2, 149, 3), np.float32), "b0": np.zeros((2, 3), np.float32)}


def _load_mlp(tmp_path):
    from stutter_tpu_torch import persist
    from stutter_tpu_torch.models.mlp import SeedMLP

    persist.save_mlp(tmp_path / "m", SeedMLP.from_jax_params(_mlp_params(), device="cpu"))
    return persist.load_mlp(tmp_path / "m")


def _call(name, tmp_path):
    from stutter_tpu_torch import pipeline
    from stutter_tpu_torch.config import FEATURES_149, DenoiseConfig
    from stutter_tpu_torch.denoise import denoise_clips
    from stutter_tpu_torch.io.decode import decode_audio, to_rate
    from stutter_tpu_torch.io.native import BatchPrefetcher, load_wav_batch
    from stutter_tpu_torch.models.mlp import SeedMLP
    from stutter_tpu_torch.ops.frontend import extract_features_numpy, run_bucketed
    from stutter_tpu_torch.ops.resample import resample

    y = np.zeros(4000, np.float32)
    calls = {
        "run_bucketed": lambda: run_bucketed([y], lambda a, n: a[:, :1], 1),
        "extract_features_numpy": lambda: extract_features_numpy([y], FEATURES_149),
        "denoise_clips": lambda: denoise_clips([y]),
        "resample": lambda: resample(y, 22050, 16000),
        "to_rate": lambda: to_rate(y, 16000, 16000),
        "decode_audio": lambda: decode_audio(_wav(tmp_path), 16000),
        "load_mlp": lambda: _load_mlp(tmp_path),
        "SeedMLP.from_jax_params": lambda: SeedMLP.from_jax_params(_mlp_params()),
        "load_wav_batch": lambda: load_wav_batch([_wav(tmp_path)], 16384),
        "BatchPrefetcher": lambda: BatchPrefetcher([_wav(tmp_path)], 16384),
        "pipeline._load_clip": lambda: pipeline._load_clip(_wav(tmp_path), 16000),
        "pipeline._denoise_with_fallback": lambda: pipeline._denoise_with_fallback(
            [y], DenoiseConfig()),
    }
    return calls[name]()


@pytest.mark.parametrize("name", [
    "run_bucketed", "extract_features_numpy", "denoise_clips", "resample", "to_rate",
    "decode_audio", "load_mlp", "SeedMLP.from_jax_params", "load_wav_batch", "BatchPrefetcher",
    "pipeline._load_clip", "pipeline._denoise_with_fallback",
])
def test_entry_points_default_to_the_card(name, tmp_path):
    """Without `device`, each runs on cuda: here, with no GPU, it raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the entry point would run on it")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        _call(name, tmp_path)
