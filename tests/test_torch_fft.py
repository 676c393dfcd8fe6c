"""Host side of the shared-memory FFT kernels (csrc/rfft_smem.cuh,
csrc/spectromel.cu, csrc/spectral_gate.cu), on the CPU.

The CUDA kernels run only on the card; what they take from the host, and
the order in which they combine it, is checked here: the twiddle table
drives a float32 NumPy emulation of the kernels' Stockham stage order and
real split against np.fft, the sparse mel ranges rebuild the dense
filterbank exactly, the tile helpers cover every frame, bin and output row
once, and an emulation of the gate's tiling (chunked IIR scan, synthesis
tiles with their halos) reproduces the plain gate."""

import numpy as np
import pytest
import torch

from stutter_tpu_torch.config import DenoiseConfig
from stutter_tpu_torch.ops import consts
from stutter_tpu_torch.ops import filterbanks as fb

torch.set_num_threads(2)


_W16 = np.exp(-2j * np.pi * np.arange(16) / 16).astype(np.complex64)


def _dft_emulated(v: list, R: int) -> list:
    """The kernels' register DFTs: radix 2 and 4 directly, 16 as 4 x 4 (DFT4
    over n1 for each n2, twiddle w16^{n2 k1}, DFT4 over n2 for each k1)."""
    if R == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if R == 4:
        a0, a1, a2, a3 = v[0] + v[2], v[0] - v[2], v[1] + v[3], -1j * (v[1] - v[3])
        return [a0 + a2, a1 + a3, a0 - a2, a1 - a3]
    a = [_dft_emulated([v[n2], v[4 + n2], v[8 + n2], v[12 + n2]], 4) for n2 in range(4)]
    a = [[a[n2][k1] * (_W16[n2 * k1] if n2 and k1 else 1) for k1 in range(4)] for n2 in range(4)]
    out = [None] * 16
    for k1 in range(4):
        for k2, y in enumerate(_dft_emulated([a[n2][k1] for n2 in range(4)], 4)):
            out[k1 + 4 * k2] = y
    return out


def _fft_emulated(z: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """[F, M] complex64 -> forward FFT along the last axis in the kernels'
    stage order: Stockham passes of radix 16 while 16 NS <= M, then 4, then
    2 (M = 256: 16 16; 512: 16 16 2; 1024: 16 16 4); butterfly j of a pass
    reads points j + r M / R, twiddles point r by w_M^{(j mod NS) r M / (R NS)}
    = tw[2 (j mod NS) r M / (R NS)], and writes point r to (j / NS) R NS +
    j mod NS + r NS."""
    F, M = z.shape
    w = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    buf, ns = z.astype(np.complex64), 1
    while ns < M:
        R = 16 if ns * 16 <= M else 4 if ns * 4 <= M else 2
        q = M // R
        j = np.arange(q)
        step = 2 * (j % ns) * (M // (R * ns))
        v = [(buf[:, j + r * q] * w[r * step]).astype(np.complex64) for r in range(R)]
        y = _dft_emulated(v, R)
        out = np.empty_like(buf)
        dst = (j // ns) * ns * R + j % ns
        for r in range(R):
            out[:, dst + r * ns] = y[r]
        buf, ns = out.astype(np.complex64), ns * R
    return buf


def _rfft_emulated(x: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """[F, n] f32 -> [F, n/2 + 1]: the M-point FFT of x[2m] + i x[2m+1], then
    the real split X[k] = ((Z[k] + conj Z[M-k]) + w^k (Z[k] - conj Z[M-k]) / i) / 2."""
    M = x.shape[-1] // 2
    Z = _fft_emulated(x[:, 0::2] + 1j * x[:, 1::2], tw)
    k = np.arange(M + 1)
    a, b = Z[:, k % M], np.conj(Z[:, (M - k) % M])
    w = tw[k, 0] + 1j * tw[k, 1]
    return (0.5 * ((a + b) + w * (a - b) / 1j)).astype(np.complex64)


def _irfft_emulated(Y: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """[F, M + 1] -> [F, 2M]: undo the split (times 2), conjugate, the same
    forward FFT, conjugate back, divide by n."""
    M = Y.shape[-1] - 1
    p = np.arange(M)
    ya, yb = Y[:, p], Y[:, M - p]
    w = tw[p, 0] - 1j * tw[p, 1]  # conj(w^p)
    zc = np.conj((ya + np.conj(yb)) + 1j * (ya - np.conj(yb)) * w)
    G = _fft_emulated(zc, tw)
    x = np.empty((Y.shape[0], 2 * M), np.float32)
    x[:, 0::2], x[:, 1::2] = G.real / (2 * M), -G.imag / (2 * M)
    return x


@pytest.mark.parametrize("n_fft", consts.FFT_SIZES)
def test_twiddles_drive_the_kernel_stage_order_to_rfft(n_fft):
    tw = consts.rfft_twiddles(n_fft)
    assert tw.shape == (n_fft, 2) and tw.dtype == np.float32
    assert (tw[[0, n_fft // 4, n_fft // 2, 3 * n_fft // 4]] == [[1, 0], [0, -1], [-1, 0], [0, 1]]).all()
    rng = np.random.RandomState(n_fft)
    x = (rng.randn(3, n_fft) * [[1.0], [1e-3], [30.0]]).astype(np.float32)
    x *= fb.hann(n_fft)
    got = _rfft_emulated(x, tw)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() / np.abs(r).max() < 1e-6


@pytest.mark.parametrize("n_fft", consts.FFT_SIZES)
def test_inverse_path_matches_irfft(n_fft):
    """The gate's synthesis: split, mask, unsplit, forward FFT of the
    conjugate == irfft of the masked spectrum."""
    tw = consts.rfft_twiddles(n_fft)
    rng = np.random.RandomState(n_fft + 1)
    x = rng.randn(2, n_fft).astype(np.float32)
    mask = rng.rand(2, n_fft // 2 + 1).astype(np.float32)
    Y = (_rfft_emulated(x, tw) * mask).astype(np.complex64)
    got = _irfft_emulated(Y, tw)
    ref = np.fft.irfft(np.fft.rfft(x.astype(np.float64), axis=-1) * mask, n=n_fft, axis=-1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-6


@pytest.mark.parametrize("sr,n_fft,n_mels", [(16000, 2048, 128), (16000, 1024, 128),
                                             (16000, 512, 128), (22050, 512, 40)])
def test_mel_ranges_rebuild_mel_fb_exactly(sr, n_fft, n_mels):
    ranges, weights = consts.mel_sparse(sr, n_fft, n_mels)
    dense = fb.mel_fb(sr, n_fft, n_mels)
    assert ranges.dtype == np.int32 and ranges.shape == (n_mels, 3)
    rebuilt = np.zeros_like(dense)
    for m, (start, length, off) in enumerate(ranges):
        rebuilt[m, start:start + length] = weights[off:off + length]
    np.testing.assert_array_equal(rebuilt, dense)
    assert ranges[-1, 2] + ranges[-1, 1] == weights.size  # packed back to back
    assert weights.size < 0.1 * dense.size  # the triangles are narrow


def _covered_once(n, tile):
    ranges = consts.tile_ranges(n, tile)
    hits = np.zeros(n, int)
    for a, b in ranges:
        assert 0 <= a < b <= n and b - a <= tile
        hits[a:b] += 1
    return (hits == 1).all(), len(ranges)


@pytest.mark.parametrize("B,N", [(1, 49152), (64, 49152), (256, 49152), (64, 163840),
                                 (1, 24576)])
def test_tile_geometry_covers_once_and_spreads_a_request(B, N):
    """Frame, bin and row tiles cover every item exactly once; one 3 s
    request puts >= NUM_SMS blocks on each gate launch and a block on every
    spectromel frame (97 frames of the 149-dim front end)."""
    T149 = N // 512 + 1
    f149 = consts.frame_tile(2048, T149, B)
    ok, n149 = _covered_once(T149, f149)
    assert ok and 1 <= f149 <= consts.TILE_POINTS // 1024
    # the gate's padded geometry (denoise.py): 30000 samples each side
    C = -(-(N + 60000) // 256) + 4
    T, K = C - 3, 513
    tiles = consts.frame_tile(1024, T, B), consts.iir_bin_tile(T, K, B), \
        consts.synth_row_tile(C, B)
    blocks = []
    for n, t in zip((T, K, C), tiles):
        ok, nb = _covered_once(n, t)
        assert ok
        blocks.append(B * nb)
    assert 8 * T * tiles[1] <= consts.IIR_SMEM
    if B == 1 and N == 49152:
        assert min(blocks) >= consts.NUM_SMS, blocks
        assert f149 == 1 and B * n149 == T149 == 97
    if B >= 64:  # a batch takes the largest tiles
        assert tiles[0] == consts.TILE_POINTS // 512 and tiles[2] == 13
        assert f149 == consts.TILE_POINTS // 1024


@pytest.mark.parametrize("n_fft,kf", [(512, 17), (1024, 33), (2048, 65)])
def test_synthesis_tile_fits_shared_memory(n_fft, kf):
    """The row tile chosen for a batch fits a block's shared memory at every
    FFT size (the kernel refuses one that does not)."""
    hop = n_fft // 4
    tt = consts.synth_row_tile(2000, 64, n_fft, hop, kf)
    assert consts.synth_smem_bytes(n_fft, hop, tt, kf) <= consts.SYNTH_SMEM
    assert tt == (13 if n_fft <= 1024 else 8)


def _iir_chunked(x: np.ndarray, b: float, segments: int) -> np.ndarray:
    """gate_iir_mask's scan: each of `segments` time segments scans locally
    from 0 (coefficient 0 and input x at the steady-state start), the
    segments' end values and coefficient products chain the carries, and
    each segment adds (prod a) carry back; forward, then backward."""
    T = x.shape[0]
    a = np.float32(1.0 - b)
    length = -(-T // segments)

    def one_way(u_of, start):
        y = np.zeros_like(x)
        local_end, prod = [], []
        for s in range(segments):
            ts, te = min(s * length, T), min(s * length + length, T)
            idx = range(ts, te) if start == 0 else range(te - 1, ts - 1, -1)
            acc, p = np.zeros_like(x[0]), np.float32(1.0)
            for t in idx:
                acc = u_of(t) if t == start else a * acc + np.float32(b) * u_of(t)
                p = np.float32(0.0) if t == start else p * a
                y[t] = acc
            local_end.append(acc)
            prod.append(p)
        order = range(segments) if start == 0 else range(segments - 1, -1, -1)
        carry = np.zeros_like(x[0])
        for s in order:
            ts, te = min(s * length, T), min(s * length + length, T)
            idx = range(ts, te) if start == 0 else range(te - 1, ts - 1, -1)
            q = np.float32(1.0)
            for t in idx:
                q = np.float32(0.0) if t == start else q * a
                y[t] = y[t] + q * carry
            carry = local_end[s] + prod[s] * carry
        return y

    fwd = one_way(lambda t: x[t], 0)
    return one_way(lambda t: fwd[t], T - 1)


@pytest.mark.parametrize("segments", [1, 8, 64, 128])
def test_chunked_iir_scan_matches_the_recurrence(segments):
    from stutter_tpu_torch.ops.consts import iir_coefficient
    from stutter_tpu_torch.ops.spectral_gate import iir_smooth_bidirectional

    b = iir_coefficient(DenoiseConfig())
    x = np.abs(np.random.RandomState(segments).randn(97, 5)).astype(np.float32)
    got = _iir_chunked(x, b, segments)
    ref = iir_smooth_bidirectional(torch.from_numpy(x[None].astype(np.float64)), b)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=0)


@pytest.mark.parametrize("prop", [1.0, 0.8])
def test_synthesis_tiles_rebuild_the_plain_gate(prop):
    """The gate's tiling in NumPy: the IIR launch smooths the mask over time
    along its whole column (zero 'same' padding); per tile of output rows,
    the synthesis launch takes the frames `synth_frames` names, smooths their
    mask rows over frequency from a zero halo, blends, recomputes the
    spectra, runs irfft and the synthesis Hann, and gathers the slots times
    winv -- equal to spectral_gate_plain, which smooths frequency first."""
    from stutter_tpu_torch.ops.spectral_gate import iir_smooth_bidirectional, spectral_gate_plain

    cfg = DenoiseConfig(prop_decrease=prop)
    n_fft, hop = cfg.n_fft, cfg.hop_length
    rng = np.random.RandomState(5)
    C = 40
    sig = (rng.randn(2, C * hop) * 0.2).astype(np.float64)
    T, K, n_rows = C - 3, n_fft // 2 + 1, C
    win = fb.hann(n_fft).astype(np.float64)
    frames = np.stack([sig[:, t * hop:t * hop + n_fft] for t in range(T)], axis=1) * win
    spec = np.fft.rfft(frames, axis=-1)
    mag = np.abs(spec)
    s = iir_smooth_bidirectional(torch.from_numpy(mag), consts.iir_coefficient(cfg)).numpy()
    above = np.where(s > 0, (mag - s) / np.where(s > 0, s, 1), 0)
    mk = 1 / (1 + np.exp(-(above - cfg.thresh_n_mult_nonstationary)
                         * cfg.sigmoid_slope_nonstationary))
    f_taps, t_taps = consts.mask_smoothing_profiles(cfg)
    kf, kt = len(f_taps), len(t_taps)
    padded_t = np.pad(mk, ((0, 0), (kt // 2, kt - 1 - kt // 2), (0, 0)))
    mk_t = sum(t_taps[j] * padded_t[:, j:j + T] for j in range(kt))  # the IIR launch's output
    winv = consts.ola_winv(T, n_fft, hop)
    out = np.zeros((2, n_rows, hop))
    for tt in (8, 3, 1):
        for r0, r1 in consts.tile_ranges(n_rows, tt):
            fa, fb_ = consts.synth_frames(r0, tt, T)
            A = np.pad(mk_t[:, fa:fb_], ((0, 0), (0, 0), (kf // 2, kf - 1 - kf // 2)))
            Mf = sum(f_taps[j] * A[:, :, j:j + K] for j in range(kf)) * prop + (1 - prop)
            xs = np.fft.irfft(spec[:, fa:fb_] * Mf, n=n_fft, axis=-1) * win
            for r in range(r0, r1):
                acc = sum(xs[:, r - sl - fa, sl * hop:(sl + 1) * hop]
                          for sl in range(4) if 0 <= r - sl < T)
                out[:, r] = acc * winv[r]
        ref = spectral_gate_plain(torch.from_numpy(sig.reshape(2, C, hop)), n_fft, hop, cfg)
        # in float64; the kernel multiplies by winv, an f32 reciprocal, where
        # the plain version divides by the window-sum-square: 1e-6 relative
        np.testing.assert_allclose(out, ref.numpy(), rtol=1e-6, atol=1e-12)
