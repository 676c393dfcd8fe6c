// WavLM's gated relative-position attention core for Hopper (sm_90a), FP32.
//
// Replaces no TPU kernel: the JAX package has no WavLM.  It was added
// because the encoder's attention core, built from PyTorch calls, wrote
// gate x bias + mask as [B, heads, T, T] tensors and ran softmax(q k^T / 8
// + that) v through scaled_dot_product_attention's math backend: a bmm, an
// add, a softmax and a second bmm, each [B, heads, T, T] step through
// device memory, on every key of every padded row.  This kernel computes,
// for each clip b, head h and query row i < max(L_b, 1),
//
//   out[b, i, h] = softmax_j(q_i . k_j / 8 + g_i E[bucket(j - i), h]) v,
//                  over keys j < max(L_b, 1),
//
// where g_i = a (b' c_h - 1) + 2, [a, b'] = sigmoid of the two sums of 4
// of gru_rel_pos_linear(x_i's head slice), and E is layer 0's
// rel_attn_embed [num_buckets, heads].  Rows past max(L_b, 1) are written
// as zeros: a padded frame is masked as a key and left out of the pooled
// mean, so it reaches no clip's output.
//
// Bound on an H100: FP32 operations.  Counted as the benchmark counts them,
// a pair of frames costs 4,224 operations a layer over 16 heads (q k^T and
// the product with v, 2 x 2 x 64 each a head, plus 8 for the bias, the
// scale and the softmax), against 67 TFLOP/s without tensor cores; the
// bytes (x, q, k, v in, the output out) are ~T / 20 times fewer.  So the
// design keeps the FMA pipes fed and nothing of size T x T in device
// memory:
//
//  * one block of 4 warps per (64-query tile, head, clip); each warp owns
//    16 query rows, each thread 4 rows x 8 keys of a 64 x 64 score tile and
//    4 rows x 8 columns of the output, in registers.  Each 4-deep step of
//    q k^T reads 12 float4 from shared memory for 128 FMAs, each 4 keys of
//    P v the same, with row strides that keep the reads free of bank
//    conflicts;
//  * q's tile stays in shared memory; the key and value tiles stream
//    through one buffer each with cp.async: the next key tile loads under
//    this tile's softmax and P v, the next value tile under the next q k^T;
//  * the work follows each clip's own length L = max(L_b, 1), not the
//    padded batch's: key tiles at or past L are never loaded (rows of the
//    last tile past it are zero-filled and masked to -inf), and of the last
//    tile only the groups of 8 keys that hold a key < L are multiplied; a
//    warp whose 16 rows all lie past L computes nothing, and a query tile
//    wholly past it writes zeros and returns.  The tiles then cover ~1.07x
//    the clips' own pairs at the corpus's lengths, where whole 64 x 64
//    tiles would cover ~1.49x;
//  * the softmax is online (running max and sum a row, the max reduced
//    over the row's 8 threads by shuffles, each thread's sum reduced once
//    at the end), with expf, not __expf;
//  * the bias is gathered by bucket once a block, along j - i, into shared
//    memory from a bucket vector over j - i in [-(R - 1), R - 1] (built
//    from the same bucket function as the plain path's table), so a score
//    costs one shared read and one FMA for it;
//  * the gate is computed in the prologue from the query rows' x (64 rows x
//    8 outputs x 64) and held a row in registers.
//
// Given a counter (`pairs`, else null), each warp adds the query-key pairs
// its threads multiplied in q k^T: what models/wavlm.attn_pairs_run (the
// second mode: models/w2v_bert.attn_pairs_run) counts from the clips'
// frames, which a card test holds to this count.
//
// A second mode, `relkey_attention_kernel`, is W2V-BERT 2.0's relative-key
// attention (models/w2v_bert.py; transformers' Wav2Vec2BertSelfAttention
// with position_embeddings_type "relative_key"):
//
//   out[b, i, h] = softmax_j((q_i . k_j + q_i . D[clamp(j - i, -left,
//                  right) + left]) / 8) v,  over keys j < L_b,
//
// where D [left + right + 1, 64] is the layer's distance_embedding, shared
// by the heads (64 + 8 + 1 = 73 rows in the published model), over packed
// rows: clip b's q, k, v and output rows are rows offsets[b] ..
// offsets[b + 1] - 1 of [R, H x 64] tensors, so L_b = offsets[b + 1] -
// offsets[b] and no padded row exists.  A block whose query tile starts at
// or past its clip's frames (a clip of no frame included) returns at once
// and writes nothing; rows past L_b in a tile are zero-filled on load (they
// are the next clip's) and never written.  One template body runs both
// modes, with the same tiling, cp.async pipeline, online softmax, length
// bounds and pairs counter; only the bias and the rows' addressing differ
// (the gated mode's padded layout, read by batch stride, is unchanged).  A
// query row meets at most 73 distinct distances, so the prologue fills a
// [64, 73] table of q_i . D_d / 8 from the q tile already in shared memory
// and D, loaded beside it while the first key and value tiles load, each
// thread 4 rows x 10 distances in registers as q k^T is tiled; a score
// then costs one shared read of the table at its clamped j - i.  That is
// 64 x 73 x 64 FMAs a block, under a fifth of q k^T's at T = 440, and
// nothing of size T x T or B x T x 73 in device memory.  The table and D
// take ~38 KB more shared memory than the gated mode's bias vector: two
// blocks share an SM where the gated mode fits three.
//
// No --use_fast_math (see _build.py).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HD = 64;        // head dim
constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr int GATE = 8;       // gru_rel_pos_linear's outputs: 2 groups of 4
constexpr int LD = 68;        // row stride (floats) of the q, k and v tiles
constexpr int LDP = 72;       // of the P tile (first the gate's x tile)
constexpr int BD_LOADS = 8;   // bias gathers a thread keeps in flight
constexpr int NREL_MAX = 80;  // distances a relative-key table holds: 10 groups of 8

enum Mode { GATED = 0, RELKEY = 1 };

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows r0 .. r0 + 63 of one head's [rows, 64] slice (row stride rs floats)
// into a [64, ld] tile; rows at or past n_rows are zero-filled.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int rs, int r0,
                                          int n_rows) {
#pragma unroll
  for (int it = 0; it < BQ * (HD / 4) / THREADS; ++it) {
    const int e = threadIdx.x + it * THREADS, r = e >> 4, col = (e & 15) << 2;
    const bool ok = r0 + r < n_rows;
    cp_async16(dst + r * ld + col, ok ? src + (long)(r0 + r) * rs + col : src, ok);
  }
}

// S += q k^T for this thread's 4 rows x 8 keys (keys c + 8 mm); with
// PARTIAL only the key groups mm < nm, the rest of the tile being past the
// clip's frames.
template <bool PARTIAL>
__device__ __forceinline__ void scores(float (&S)[4][8], const float* Qs, const float* Ks,
                                       const int (&rr)[4], int c, int nm) {
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 qf[4], kf[8];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) qf[ii] = *reinterpret_cast<const float4*>(Qs + rr[ii] * LD + d);
#pragma unroll
    for (int mm = 0; mm < 8; ++mm)
      if (!PARTIAL || mm < nm)
        kf[mm] = *reinterpret_cast<const float4*>(Ks + (c + 8 * mm) * LD + d);
#pragma unroll
    for (int mm = 0; mm < 8; ++mm) {
      if (PARTIAL && mm >= nm) continue;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        float s = S[ii][mm];
        s = fmaf(qf[ii].x, kf[mm].x, s);
        s = fmaf(qf[ii].y, kf[mm].y, s);
        s = fmaf(qf[ii].z, kf[mm].z, s);
        s = fmaf(qf[ii].w, kf[mm].w, s);
        S[ii][mm] = s;
      }
    }
  }
}

// O += P v over the tile's first nj keys (a multiple of 8; 64 unless
// PARTIAL) for this thread's 4 rows x columns 4 c .. + 3 and 32 + 4 c .. + 3.
template <bool PARTIAL>
__device__ __forceinline__ void weigh(float (&O)[4][8], const float* Ps, const float* Vs,
                                      const int (&rr)[4], int c, int nj) {
#pragma unroll 2
  for (int j = 0; j < (PARTIAL ? nj : BK); j += 4) {
    float4 pf[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) pf[ii] = *reinterpret_cast<const float4*>(Ps + rr[ii] * LDP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 v0 = *reinterpret_cast<const float4*>(Vs + (j + jj) * LD + 4 * c);
      const float4 v1 = *reinterpret_cast<const float4*>(Vs + (j + jj) * LD + 32 + 4 * c);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float p = jj == 0 ? pf[ii].x : jj == 1 ? pf[ii].y : jj == 2 ? pf[ii].z : pf[ii].w;
        O[ii][0] = fmaf(p, v0.x, O[ii][0]);
        O[ii][1] = fmaf(p, v0.y, O[ii][1]);
        O[ii][2] = fmaf(p, v0.z, O[ii][2]);
        O[ii][3] = fmaf(p, v0.w, O[ii][3]);
        O[ii][4] = fmaf(p, v1.x, O[ii][4]);
        O[ii][5] = fmaf(p, v1.y, O[ii][5]);
        O[ii][6] = fmaf(p, v1.z, O[ii][6]);
        O[ii][7] = fmaf(p, v1.w, O[ii][7]);
      }
    }
  }
}

// Tb[r * ldt + d] = q_r . D_d / 8 for this thread's 4 rows and the
// distances d = c + 8 mm < nrel (mm < NREL_MAX / 8), from the q tile and D
// in shared memory, tiled as q k^T is.
__device__ __forceinline__ void rel_table(float* Tb, int ldt, const float* Qs, const float* Ds,
                                          const int (&rr)[4], int c, int nrel) {
  constexpr int NG = NREL_MAX / 8;
  float S[4][NG];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int mm = 0; mm < NG; ++mm) S[ii][mm] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 qf[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) qf[ii] = *reinterpret_cast<const float4*>(Qs + rr[ii] * LD + d);
#pragma unroll
    for (int mm = 0; mm < NG; ++mm) {
      if (c + 8 * mm >= nrel) continue;
      const float4 df = *reinterpret_cast<const float4*>(Ds + (c + 8 * mm) * LD + d);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        float t = S[ii][mm];
        t = fmaf(qf[ii].x, df.x, t);
        t = fmaf(qf[ii].y, df.y, t);
        t = fmaf(qf[ii].z, df.z, t);
        t = fmaf(qf[ii].w, df.w, t);
        S[ii][mm] = t;
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int mm = 0; mm < NG; ++mm)
      if (c + 8 * mm < nrel) Tb[rr[ii] * ldt + c + 8 * mm] = S[ii][mm] * 0.125f;
}

// The table's row stride: odd, so the 4 rows a warp reads at once fall on
// different banks.
__host__ __device__ __forceinline__ int rel_stride(int nrel) { return nrel | 1; }

// One block of either mode.  GATED reads x, gw, gb, gc, emb (layer 0's
// bucket embedding), buckets, and `lengths` as each clip's frames of the
// padded [B, T] rows; RELKEY reads emb as D [left + right + 1, 64], left
// and right, and `lengths` as the packed rows' offsets [B + 1] (its batch
// strides unused).
template <int MODE>
__device__ __forceinline__ void attention_block(
    const float* __restrict__ x, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ gw, const float* __restrict__ gb,
    const float* __restrict__ gc, const float* __restrict__ emb, const int* __restrict__ buckets,
    const int* __restrict__ lengths, float* __restrict__ out, unsigned long long* __restrict__ pairs,
    int T, int H, int R, int left, int right, int xsb, int xsr, int qsb, int qsr, int ksb, int ksr,
    int vsb, int vsr) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [BQ, LD]
  float* Ks = Qs + BQ * LD;    // [BK, LD]
  float* Vs = Ks + BK * LD;    // [BK, LD]
  float* Ps = Vs + BK * LD;    // [BQ, LDP]: GATED the gate's x tile, then P
  float* Bd = Ps + BQ * LDP;   // GATED: bias along j - i: [n_keys + BQ - 1]
  const int nrel = left + right + 1, ldt = rel_stride(nrel);
  float* Tb = Bd;              // RELKEY: [BQ, ldt], q_i . D_d / 8
  float* Ds = Tb + BQ * ldt;   // RELKEY: D [nrel, LD]
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BQ;
  // the clip's rows: GATED T padded rows at b x the batch strides, of which
  // L are its own; RELKEY its L packed rows from row0
  long row0 = 0;
  int L, rows;
  if constexpr (MODE == GATED) {
    L = max(min(lengths[b], T), 1);
    rows = T;
  } else {
    row0 = lengths[b];
    L = rows = lengths[b + 1] - lengths[b];
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 3, c = lane & 7;  // row group, key / column group
  const int D = H * HD;
  float* o = out + (MODE == GATED ? (long)b * T * D : row0 * D) + h * HD;

  if (i0 >= L) {  // every row of the tile is padding (none, packed)
    for (int e = tid; e < BQ * (HD / 4); e += THREADS) {
      const int r = i0 + (e >> 4);
      if (r < rows)
        *reinterpret_cast<float4*>(o + (long)r * D + ((e & 15) << 2)) = make_float4(0, 0, 0, 0);
    }
    return;
  }
  const int n_kt = (L + BK - 1) / BK;
  const float* kb = k + (MODE == GATED ? (long)b * ksb : row0 * ksr) + h * HD;
  const float* vb = v + (MODE == GATED ? (long)b * vsb : row0 * vsr) + h * HD;
  int rr[4];  // this thread's rows in the tile
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) rr[ii] = warp * 16 + g + 4 * ii;
  // a warp whose 16 rows are all padding only loads and waits
  const bool busy = i0 + warp * 16 < L;
  float gr[4];  // GATED: the gate of each of this thread's rows

  if constexpr (MODE == GATED) {
    load_tile(Ps, LDP, x + (long)b * xsb + h * HD, xsr, i0, T);
    load_tile(Qs, LD, q + (long)b * qsb + h * HD, qsr, i0, T);
    load_tile(Ks, LD, kb, ksr, 0, L);
    cp_async_commit();
    load_tile(Vs, LD, vb, vsr, 0, L);
    cp_async_commit();

    // the bias along j - i: Bd[j - (i - i0) + BQ - 1] for this tile's rows,
    // BD_LOADS buckets a thread in flight, then their embeddings
    const int n_bd = n_kt * BK + BQ - 1;
    for (int e0 = tid; e0 < n_bd; e0 += BD_LOADS * THREADS) {
      int bk[BD_LOADS];
#pragma unroll
      for (int u = 0; u < BD_LOADS; ++u) {
        const int rel = min(max(e0 + u * THREADS - (BQ - 1) - i0, 1 - R), R - 1);
        bk[u] = e0 + u * THREADS < n_bd ? __ldg(buckets + rel + R - 1) : 0;
      }
#pragma unroll
      for (int u = 0; u < BD_LOADS; ++u)
        if (e0 + u * THREADS < n_bd) Bd[e0 + u * THREADS] = __ldg(emb + bk[u] * H + h);
    }
    cp_async_wait<1>();
    __syncthreads();

    // the gate: thread -> row tid / 2 and one group of 4 outputs, summed
    const int r = tid >> 1, k0 = (tid & 1) * (GATE / 2);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(Ps + r * LDP + d);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(gw + (k0 + kk) * HD + d));
        acc[kk] = fmaf(xv.x, w.x, acc[kk]);
        acc[kk] = fmaf(xv.y, w.y, acc[kk]);
        acc[kk] = fmaf(xv.z, w.z, acc[kk]);
        acc[kk] = fmaf(xv.w, w.w, acc[kk]);
      }
    }
    float s = acc[0] + __ldg(gb + k0);
#pragma unroll
    for (int kk = 1; kk < 4; ++kk) s += acc[kk] + __ldg(gb + k0 + kk);
    const float sig = 1.f / (1.f + expf(-s));
    const float other = __shfl_xor_sync(0xffffffffu, sig, 1);
    // a row's gate in the P tile's padding column; past this barrier every
    // row's x is read, and P may overwrite it
    if ((tid & 1) == 0) Ps[r * LDP + HD] = sig * (other * __ldg(gc + h) - 1.f) + 2.f;
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) gr[ii] = Ps[rr[ii] * LDP + HD];
  } else {
    // q's tile and D, then the first key and value tiles, which load while
    // the table is filled
    load_tile(Qs, LD, q + row0 * qsr + h * HD, qsr, i0, rows);
    for (int e = tid; e < nrel * (HD / 4); e += THREADS)
      cp_async16(Ds + (e >> 4) * LD + ((e & 15) << 2), emb + (e >> 4) * HD + ((e & 15) << 2),
                 true);
    cp_async_commit();
    load_tile(Ks, LD, kb, ksr, 0, L);
    cp_async_commit();
    load_tile(Vs, LD, vb, vsr, 0, L);
    cp_async_commit();
    cp_async_wait<2>();  // q and D are in
    __syncthreads();
    if (busy) rel_table(Tb, ldt, Qs, Ds, rr, c, nrel);
    cp_async_wait<1>();  // the first key tile is in
    __syncthreads();     // and every row's table written
  }

  float O[4][8], m[4], l[4];
  int run = 0;  // pairs this thread multiplied in q k^T
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = -INFINITY;
    l[ii] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) O[ii][e] = 0.f;
  }

  for (int t = 0; t < n_kt; ++t) {
    const int j0 = t * BK;
    // key groups of 8 holding keys < L: the last tile's rest is skipped
    const int nm = min(8, (L - j0 + 7) >> 3);
    float S[4][8];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int mm = 0; mm < 8; ++mm) S[ii][mm] = 0.f;
    if (busy) {
      if (nm == 8)
        scores<false>(S, Qs, Ks, rr, c, 8);
      else
        scores<true>(S, Qs, Ks, rr, c, nm);
      run += 4 * nm;
    }
    __syncthreads();  // the key tile is spent
    const bool more = t + 1 < n_kt;
    if (more) {
      load_tile(Ks, LD, kb, ksr, j0 + BK, L);
      cp_async_commit();
    }

    const bool edge = j0 + BK > L;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      if (!busy) break;
      float mx = -INFINITY;
      if constexpr (MODE == GATED) {
        const float* bd = Bd + j0 + c - rr[ii] + BQ - 1;
#pragma unroll
        for (int mm = 0; mm < 8; ++mm) S[ii][mm] = fmaf(S[ii][mm], 0.125f, gr[ii] * bd[8 * mm]);
      } else {
        const float* tb = Tb + rr[ii] * ldt;
        const int rel = j0 + c - i0 - rr[ii];  // j - i of key group 0
#pragma unroll
        for (int mm = 0; mm < 8; ++mm)
          S[ii][mm] = fmaf(S[ii][mm], 0.125f, tb[min(max(rel + 8 * mm, -left), right) + left]);
      }
#pragma unroll
      for (int mm = 0; mm < 8; ++mm) {
        if (edge && j0 + c + 8 * mm >= L) S[ii][mm] = -INFINITY;
        mx = fmaxf(mx, S[ii][mm]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[ii], mx);
      const float corr = expf(m[ii] - mn);
      m[ii] = mn;
      float ls = 0.f;
#pragma unroll
      for (int mm = 0; mm < 8; ++mm) {
        const float p = expf(S[ii][mm] - mn);
        Ps[rr[ii] * LDP + c + 8 * mm] = p;
        ls += p;
      }
      l[ii] = l[ii] * corr + ls;
#pragma unroll
      for (int e = 0; e < 8; ++e) O[ii][e] *= corr;
    }
    if (more)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // the value tile and P are in

    if (busy) {
      if (nm == 8)
        weigh<false>(O, Ps, Vs, rr, c, BK);
      else
        weigh<true>(O, Ps, Vs, rr, c, 8 * nm);
    }
    if (more) {
      __syncthreads();  // the value tile and P are spent
      load_tile(Vs, LD, vb, vsr, j0 + BK, L);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // the next key tile is in
    }
  }

  if (pairs != nullptr) {
    run += __shfl_xor_sync(0xffffffffu, run, 1);
    run += __shfl_xor_sync(0xffffffffu, run, 2);
    run += __shfl_xor_sync(0xffffffffu, run, 4);
    run += __shfl_xor_sync(0xffffffffu, run, 8);
    run += __shfl_xor_sync(0xffffffffu, run, 16);
    if (lane == 0 && run > 0) atomicAdd(pairs, (unsigned long long)run);
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    float lt = l[ii];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    const int i = i0 + rr[ii];
    if (i >= rows) continue;
    float4 a = make_float4(0, 0, 0, 0), z = a;
    if (i < L) {
      a = make_float4(O[ii][0] / lt, O[ii][1] / lt, O[ii][2] / lt, O[ii][3] / lt);
      z = make_float4(O[ii][4] / lt, O[ii][5] / lt, O[ii][6] / lt, O[ii][7] / lt);
    }
    *reinterpret_cast<float4*>(o + (long)i * D + 4 * c) = a;
    *reinterpret_cast<float4*>(o + (long)i * D + 32 + 4 * c) = z;
  }
}

__global__ void __launch_bounds__(THREADS, 3)
    gated_attention_kernel(const float* __restrict__ x, const float* __restrict__ q,
                           const float* __restrict__ k, const float* __restrict__ v,
                           const float* __restrict__ gw, const float* __restrict__ gb,
                           const float* __restrict__ gc, const float* __restrict__ emb,
                           const int* __restrict__ buckets, const int* __restrict__ lengths,
                           float* __restrict__ out, unsigned long long* __restrict__ pairs,
                           int T, int H, int R, int xsb, int xsr,
                           int qsb, int qsr, int ksb, int ksr, int vsb, int vsr) {
  attention_block<GATED>(x, q, k, v, gw, gb, gc, emb, buckets, lengths, out, pairs, T, H, R, 0, 0,
                         xsb, xsr, qsb, qsr, ksb, ksr, vsb, vsr);
}

__global__ void __launch_bounds__(THREADS, 2)
    relkey_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dist,
                            const int* __restrict__ offsets, float* __restrict__ out,
                            unsigned long long* __restrict__ pairs, int T, int H, int left,
                            int right, int qsr, int ksr, int vsr) {
  attention_block<RELKEY>(nullptr, q, k, v, nullptr, nullptr, nullptr, dist, nullptr, offsets, out,
                          pairs, T, H, 0, left, right, 0, 0, 0, qsr, 0, ksr, 0, vsr);
}

// Shared memory a block needs for T frames.
int smem_bytes(int T) {
  const int n_keys = (T + BK - 1) / BK * BK;
  return (int)sizeof(float) * (3 * BQ * LD + BQ * LDP + n_keys + BQ - 1);
}

// Shared memory a relative-key block needs for nrel distances: the table
// and D in place of the bias vector.
int relkey_smem_bytes(int nrel) {
  return (int)sizeof(float) * (3 * BQ * LD + BQ * LDP + BQ * rel_stride(nrel) + nrel * LD);
}

}  // namespace

// x, q, k, v: [B, T, H x 64] float32 views (last stride 1, the batch and row
// strides in floats, multiples of 4, 16-byte aligned); gw [8, 64], gb [8],
// gc [H]; emb [num_buckets, H]; buckets [2R - 1] int32, bucket of j - i at
// j - i + R - 1 (R >= T); lengths [B] int32 frames; out [B, T, H x 64];
// pairs null, or a uint64 the kernel adds the pairs it multiplied to.
extern "C" int gated_attention_launch(const void* x, const void* q, const void* k, const void* v,
                                      const void* gw, const void* gb, const void* gc,
                                      const void* emb, const void* buckets, const void* lengths,
                                      void* out, void* pairs, int B, int T, int H, int R, int xsb, int xsr,
                                      int qsb, int qsr, int ksb, int ksr, int vsb, int vsr,
                                      void* stream) {
  if (B < 1 || T < 1 || H < 1 || R < T) return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes(T);
  cudaError_t err = cudaFuncSetAttribute(gated_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  gated_attention_kernel<<<dim3((T + BQ - 1) / BQ, H, B), THREADS, bytes,
                           (cudaStream_t)stream>>>(
      (const float*)x, (const float*)q, (const float*)k, (const float*)v, (const float*)gw,
      (const float*)gb, (const float*)gc, (const float*)emb, (const int*)buckets,
      (const int*)lengths, (float*)out, (unsigned long long*)pairs, T, H, R, xsb, xsr, qsb, qsr, ksb, ksr, vsb, vsr);
  return (int)cudaGetLastError();
}

// q, k, v: [R, H x 64] float32 views of packed rows (last stride 1, the
// row strides in floats, multiples of 4, 16-byte aligned); dist
// [left + right + 1, 64] float32, contiguous and 16-byte aligned, at most
// NREL_MAX rows; offsets [B + 1] int32, clip b's rows offsets[b] ..
// offsets[b + 1] - 1; T the longest clip's rows; out [R, H x 64]; pairs
// null, or a uint64 the kernel adds the pairs it multiplied to.
extern "C" int relkey_attention_launch(const void* q, const void* k, const void* v,
                                       const void* dist, const void* offsets, void* out,
                                       void* pairs, int B, int T, int H, int left, int right,
                                       int qsr, int ksr, int vsr, void* stream) {
  if (B < 1 || T < 1 || H < 1 || left < 0 || right < 0 || left + right + 1 > NREL_MAX)
    return (int)cudaErrorInvalidValue;
  const int bytes = relkey_smem_bytes(left + right + 1);
  cudaError_t err = cudaFuncSetAttribute(relkey_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  relkey_attention_kernel<<<dim3((T + BQ - 1) / BQ, H, B), THREADS, bytes,
                            (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dist, (const int*)offsets,
      (float*)out, (unsigned long long*)pairs, T, H, left, right, qsr, ksr, vsr);
  return (int)cudaGetLastError();
}
