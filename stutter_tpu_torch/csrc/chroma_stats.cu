// Chroma-apply + statistics kernel for Hopper (sm_90a), FP32.
//
// Replaces stutter_tpu/ops/pallas_chroma.py:chroma_stats_pallas (body
// _chroma_stats_kernel): frame-masked power [B, T, K] + tuning bin [B] +
// valid frame count [B] -> [B, 24], the masked mean and then the population
// std, over the clip's valid frames, of its chroma: the 12 filterbank rows
// of its tuning bin (rows tb * 12 ... of the [100 * 12, K] table) against
// each power frame, inf-normalised per frame (a max below f32 tiny divides
// by 1).
//
// Bounds on an H100: the kernel reads the clip's valid power frames once
// (102 MB for 256 clips of 3 s) and does 12 FMAs per value read, so it is
// bound by device-memory bandwidth; a single 3 s request (398 KB) is bound
// by how many SMs stream it.  The design:
//
//  * A thread-block cluster of CS blocks per clip (CS <= 8, portable; the
//    wrapper picks it from B and T so that one request spreads over 8 SMs
//    and a batch keeps ~2 blocks an SM).  Groups of 4 frames are dealt to
//    the cluster's warps in turn.
//  * The clip's 12 filterbank rows (padded to KP, a multiple of 128 with at
//    least 3 zeros past K) are staged once per cluster: the leader block
//    starts one bulk copy, multicast to every block of the cluster, which
//    completes on each block's mbarrier.  Every warp starts its first power
//    loads before it waits for the rows.
//  * Register blocking over frames: a warp forms 4 frames at once, 128 bins
//    a step (4 a lane), so each 16-byte filterbank vector it reads from
//    shared memory serves 4 frames (48 accumulators a lane; 3 shared bytes
//    per power byte, where one frame at a time takes 12).  Power rows are
//    K = 1025 floats, so a row starts at any float offset: a lane loads the
//    aligned float4 under its 4 bins and takes the bins that spill into the
//    next float4 from the next lane by shuffle (lane 31 from lane 0's
//    load of the next step).  The next two steps' 8 loads are in flight
//    while the current step's 192 FMAs run.
//  * Each frame's 12 dot products are warp sums (a fixed shuffle tree), and
//    the normalised chroma row goes to the leader block's shared memory
//    through distributed shared memory.  After cluster.sync() the leader
//    forms each channel's masked mean, then the centred variance, in a
//    fixed order (lane-strided frames, then the shuffle tree), so the
//    result does not change from run to run.
//
// Frames past n_valid are never read; n_valid = 0 gives zeros.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NCH = 12;
constexpr int FRAMES = 4;    // frames a warp forms at once
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int CHUNK = 128;   // bins a warp covers a step: 32 lanes x 4
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_SMEM = 232448;
constexpr float F32_TINY = 1.17549435e-38f;

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src),
                     __shfl_sync(0xffffffffu, v.z, src), __shfl_sync(0xffffffffu, v.w, src));
}

// Row elements k .. k + 3, from the aligned float4 x that holds elements
// k - r .. k - r + 3 and the float4 y after it.
__device__ inline float4 align4(float4 x, float4 y, int r) {
  switch (r) {
    case 0: return x;
    case 1: return make_float4(x.y, x.z, x.w, y.x);
    case 2: return make_float4(x.z, x.w, y.x, y.y);
    default: return make_float4(x.w, y.x, y.y, y.z);
  }
}

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(phase) : "memory");
  } while (!done);
}

// One frame of a group: where its row lies in `power` (float4 index q of the
// aligned start, offset r of the row in it) and the float index `lim` its
// loads stay below (0 for a frame past n_valid: never read).
struct Row {
  long q, lim;
  int r;
};

__device__ inline float4 load4(const float4* __restrict__ p4, const Row& w, int i) {
  const long a = w.q + i;
  return 4 * a < w.lim ? __ldg(p4 + a) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// grid (CS, B), cluster (CS, 1, 1): blockIdx.y is the clip.
__global__ void __launch_bounds__(THREADS)
    chroma_stats_kernel(const float* __restrict__ power, const int* __restrict__ tb,
                        const int* __restrict__ n_valid, const float* __restrict__ table,
                        int n_bins, int T, int K, int KP, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* fbk = smem;                 // [NCH * KP] the clip's filterbank rows
  float* chroma = fbk + NCH * KP;    // [T * NCH] the leader's gathers every frame
  uint64_t* bar = reinterpret_cast<uint64_t*>(chroma + T * NCH);

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = min(max(n_valid[b], 0), T);
  // an out-of-range bin would read outside the table: clamp to its ends
  const int bin = min(max(tb[b], 0), n_bins - 1);
  const uint32_t bytes = (uint32_t)(NCH * KP * sizeof(float));

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  }
  cluster.sync();  // every block expects the rows before the copy starts
  if (rank == 0 && threadIdx.x == 0) {
    const float* src = table + (size_t)bin * NCH * KP;
    if (cs > 1) {
      const uint16_t mask = (uint16_t)((1u << cs) - 1u);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
          " [%0], [%1], %2, [%3], %4;\n"
          :: "r"(smem_addr(fbk)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
          : "memory");
    } else {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(fbk)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
    }
  }

  float* lead = cluster.map_shared_rank(chroma, 0);
  const float4* p4 = reinterpret_cast<const float4*>(power);
  const int groups = (nv + FRAMES - 1) / FRAMES, steps = KP / CHUNK;
  const int stride = cs * NWARPS;
  int g = rank * NWARPS + warp;

  // step s of a group uses cur; n1 and n2 hold steps s + 1 and s + 2 in
  // flight (lane 31 takes its spill from lane 0's n1, loaded a step ago)
  Row row[FRAMES];
  float4 cur[FRAMES], n1[FRAMES], n2[FRAMES];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto start = [&](int grp) {
#pragma unroll
    for (int j = 0; j < FRAMES; ++j) {
      const int t = grp * FRAMES + j;
      const long base = ((long)b * T + t) * K;
      row[j].r = (int)(base & 3);
      row[j].q = (base - row[j].r) / 4;
      row[j].lim = t < nv ? base + K : 0;
      n1[j] = load4(p4, row[j], lane);
      n2[j] = steps > 1 ? load4(p4, row[j], 32 + lane) : zero;
    }
  };
  if (g < groups) start(g);  // the first loads go out before the rows have landed
  mbar_wait(smem_addr(bar), 0);

  for (; g < groups; g += stride) {
    if (g != rank * NWARPS + warp) start(g);
    float acc[FRAMES][NCH];
#pragma unroll
    for (int j = 0; j < FRAMES; ++j)
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[j][c] = 0.f;

    for (int s = 0; s < steps; ++s) {
      const bool more = s + 1 < steps;
#pragma unroll
      for (int j = 0; j < FRAMES; ++j) {
        cur[j] = n1[j];
        n1[j] = n2[j];
        if (s + 2 < steps) n2[j] = load4(p4, row[j], (s + 2) * 32 + lane);
      }
      const int k0 = s * CHUNK + 4 * lane;
      float4 v[FRAMES];
#pragma unroll
      for (int j = 0; j < FRAMES; ++j) {
        v[j] = cur[j];
        if (row[j].r) {  // uniform across the warp
          const float4 y = shfl4(lane == 0 ? (more ? n1[j] : zero) : cur[j], (lane + 1) & 31);
          v[j] = align4(cur[j], y, row[j].r);
        }
        if (s * CHUNK + CHUNK > K) {  // bins past the row: whatever memory holds there
          if (k0 + 0 >= K) v[j].x = 0.f;
          if (k0 + 1 >= K) v[j].y = 0.f;
          if (k0 + 2 >= K) v[j].z = 0.f;
          if (k0 + 3 >= K) v[j].w = 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 f = *reinterpret_cast<const float4*>(fbk + c * KP + k0);
#pragma unroll
        for (int j = 0; j < FRAMES; ++j) {
          float a = acc[j][c];
          a = fmaf(v[j].x, f.x, a);
          a = fmaf(v[j].y, f.y, a);
          a = fmaf(v[j].z, f.z, a);
          a = fmaf(v[j].w, f.w, a);
          acc[j][c] = a;
        }
      }
    }

#pragma unroll
    for (int j = 0; j < FRAMES; ++j) {
      float denom = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        acc[j][c] = warp_sum(acc[j][c]);
        denom = fmaxf(denom, fabsf(acc[j][c]));
      }
      if (denom < F32_TINY) denom = 1.f;
      const int t = g * FRAMES + j;
      if (t < nv && lane < NCH) {
        float x = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) x = (c == lane) ? acc[j][c] : x;
        lead[t * NCH + lane] = x / denom;
      }
    }
  }
  cluster.sync();  // every frame's row is in the leader's shared memory
  if (rank != 0) return;

  const float cnt = (float)max(nv, 1);
  for (int c = warp; c < NCH; c += NWARPS) {
    float s = 0.f;
    for (int t = lane; t < nv; t += 32) s += chroma[t * NCH + c];
    const float mean = warp_sum(s) / cnt;
    float v = 0.f;
    for (int t = lane; t < nv; t += 32) {
      const float d = chroma[t * NCH + c] - mean;
      v += d * d;
    }
    const float stdv = sqrtf(warp_sum(v) / cnt);
    if (lane == 0) {
      out[(size_t)b * 2 * NCH + c] = mean;
      out[(size_t)b * 2 * NCH + NCH + c] = stdv;
    }
  }
}

}  // namespace

// power [B, T, K] (16-byte aligned), table [n_bins * 12, KP] (rows padded
// with zeros to KP, a multiple of 128 and >= K + 3), cs blocks per clip.
extern "C" int chroma_stats_launch(const void* power, const void* tb, const void* n_valid,
                                   const void* table, void* out, int B, int T, int K, int KP,
                                   int n_bins, int cs, void* stream) {
  if (cs < 1 || cs > MAX_CLUSTER || KP % CHUNK != 0 || KP < K + 3 || n_bins < 1 ||
      (uintptr_t)power % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)NCH * KP + (size_t)T * NCH) + sizeof(uint64_t);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chroma_stats_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, chroma_stats_kernel, (const float*)power, (const int*)tb,
                           (const int*)n_valid, (const float*)table, n_bins, T, K, KP,
                           (float*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
