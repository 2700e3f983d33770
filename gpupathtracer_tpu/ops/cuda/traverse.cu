// Per-thread wide-BVH traversal for NVIDIA GPUs, called from JAX through
// the XLA foreign function interface.
//
// One thread traces one ray with its own stack, the design of the
// reference's if-if traversal (src/shaders/common/BVH.glsl:634-854): pop an
// entry, slab-test the node's 8 children and push the hit ones far-to-near
// (closest-hit) or in row order (any-hit), or run the leaf's Moller-Trumbore
// tests. Results match ops/traverse.py closest_hit / any_hit: the same slab
// and triangle tests with the same strict inequalities.
//
// Inputs
//   rows  [M, 128] f32  merged node/leaf table (bvh/types.py WideBVH.node_rows,
//                       or one device's table of bvh/partition.py)
//   rays  [N, 8]   f32  (o.xyz, t_max, d.xyz, root entry bit-cast to i32);
//                       root = INVALID_ENTRY marks an inactive lane
// Results
//   hits  [N, 4]   f32  (t, u, v, prim bit-cast to i32); t_max and prim -1
//                       on a miss
//   pops  [N]      i32  stack entries popped (nodes + leaves) per ray
// Attributes
//   stack_depth         entries a ray's stack may hold; pushes beyond it are
//                       dropped, never written
//   any_hit             1: stop at the first hit inside (0, t_max)

#include <cmath>
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kArity = 8;
constexpr int kRowWidth = 128;
constexpr int kSlotWidth = 12;  // p0.xyz, e1.xyz, e2.xyz, prim id, pad, pad
constexpr int32_t kInvalid = 0x7FFFFFFF;
constexpr int kBlock = 128;

struct Ray {
  float ox, oy, oz, tmax, dx, dy, dz;
  int root;
};

__device__ __forceinline__ Ray load_ray(const float4* rays, int i) {
  float4 a = __ldg(rays + 2 * i);
  float4 b = __ldg(rays + 2 * i + 1);
  return Ray{a.x, a.y, a.z, a.w, b.x, b.y, b.z, __float_as_int(b.w)};
}

// 1/d with tiny components clamped, as ops/traverse.py _safe_inv.
__device__ __forceinline__ float safe_inv(float d) {
  float mag = fmaxf(fabsf(d), 1e-12f);
  return (d >= 0.0f ? 1.0f : -1.0f) / mag;
}

template <int MAXD, bool ANY_HIT>
__device__ void trace(const float4* __restrict__ rows, const Ray& r,
                      int stack_depth, float4* __restrict__ hit_out,
                      int* __restrict__ pops_out) {
  float t = r.tmax, hu = 0.0f, hv = 0.0f;
  int prim = -1, pops = 0;
  if (r.root != kInvalid) {
    const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
    int stack[MAXD];
    int sp = 1;
    stack[0] = r.root;
    while (sp > 0) {
      const int entry = stack[--sp];
      ++pops;
      if (entry >= 0) {
        // Node row: cols 0:48 = 8 x (min.xyz, max.xyz), cols 48:56 entries.
        const float4* row = rows + static_cast<int64_t>(entry) * (kRowWidth / 4);
        float f[7 * kArity];
#pragma unroll
        for (int q = 0; q < 7 * kArity / 4; ++q) {
          const float4 v = __ldg(row + q);
          f[4 * q] = v.x;
          f[4 * q + 1] = v.y;
          f[4 * q + 2] = v.z;
          f[4 * q + 3] = v.w;
        }
        float tn[kArity];
        unsigned mask = 0;
#pragma unroll
        for (int j = 0; j < kArity; ++j) {
          const float* b = f + 6 * j;
          const float x0 = (b[0] - r.ox) * ix, x1 = (b[3] - r.ox) * ix;
          const float y0 = (b[1] - r.oy) * iy, y1 = (b[4] - r.oy) * iy;
          const float z0 = (b[2] - r.oz) * iz, z1 = (b[5] - r.oz) * iz;
          const float lo = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)),
                                 fminf(z0, z1));
          const float hi = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)),
                                 fmaxf(z0, z1));
          tn[j] = lo;
          const bool h = (lo <= hi) & (hi > 0.0f) & (lo < t) &
                         (__float_as_int(f[6 * kArity + j]) != kInvalid);
          mask |= static_cast<unsigned>(h) << j;
        }
        if (ANY_HIT) {
#pragma unroll
          for (int j = 0; j < kArity; ++j) {
            if (((mask >> j) & 1u) && sp < stack_depth) {
              stack[sp++] = __float_as_int(f[6 * kArity + j]);
            }
          }
        } else {
          // Farthest first, so the nearest child is popped next (ties keep
          // row order, as the stable argsort of the XLA traversal).
          while (mask) {
            int best = 0;
            float bt = -INFINITY;
#pragma unroll
            for (int j = 0; j < kArity; ++j) {
              if (((mask >> j) & 1u) && tn[j] >= bt) {
                bt = tn[j];
                best = j;
              }
            }
            mask &= ~(1u << best);
            int e = 0;
#pragma unroll
            for (int j = 0; j < kArity; ++j) {
              if (j == best) e = __float_as_int(f[6 * kArity + j]);
            }
            if (sp < stack_depth) stack[sp++] = e;
          }
        }
      } else {
        // Leaf: -(row << 4 | count) - 1; triangle k at cols 12k..12k+9.
        const int packed = -(entry + 1);
        const float4* row =
            rows + static_cast<int64_t>(packed >> 4) * (kRowWidth / 4);
        const int count = packed & 15;
        for (int k = 0; k < count; ++k) {
          const float4* slot = row + (kSlotWidth / 4) * k;
          const float4 a = __ldg(slot);
          const float4 b = __ldg(slot + 1);
          const float4 c = __ldg(slot + 2);
          // a = (p0.xyz, e1.x), b = (e1.yz, e2.xy), c = (e2.z, id, pad, pad)
          const float e1x = a.w, e1y = b.x, e1z = b.y;
          const float e2x = b.z, e2y = b.w, e2z = c.x;
          const float px = r.dy * e2z - r.dz * e2y;
          const float py = r.dz * e2x - r.dx * e2z;
          const float pz = r.dx * e2y - r.dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const float idet = 1.0f / det;
          const float tx = r.ox - a.x, ty = r.oy - a.y, tz = r.oz - a.z;
          const float uu = (tx * px + ty * py + tz * pz) * idet;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float vv = (r.dx * qx + r.dy * qy + r.dz * qz) * idet;
          const float tt = (e2x * qx + e2y * qy + e2z * qz) * idet;
          if ((uu > 0.0f) & (uu < 1.0f) & (vv > 0.0f) & (uu + vv < 1.0f) &
              (tt > 0.0f) & (tt < t)) {
            t = tt;
            hu = uu;
            hv = vv;
            prim = __float_as_int(c.y);
          }
        }
        if (ANY_HIT && prim >= 0) break;
      }
    }
  }
  *hit_out = make_float4(t, hu, hv, __int_as_float(prim));
  *pops_out = pops;
}

template <int MAXD, bool ANY_HIT>
__global__ void __launch_bounds__(kBlock)
    traverse_kernel(const float4* __restrict__ rows,
                    const float4* __restrict__ rays, int n, int stack_depth,
                    float4* __restrict__ hits, int* __restrict__ pops) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  trace<MAXD, ANY_HIT>(rows, load_ray(rays, i), stack_depth, hits + i,
                       pops + i);
}

template <int MAXD, bool ANY_HIT>
void launch(cudaStream_t stream, const float4* rows, const float4* rays,
            int n, int stack_depth, float4* hits, int* pops) {
  const int grid = (n + kBlock - 1) / kBlock;
  traverse_kernel<MAXD, ANY_HIT><<<grid, kBlock, 0, stream>>>(
      rows, rays, n, stack_depth, hits, pops);
}

ffi::Error TraverseImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> rows,
                        ffi::Buffer<ffi::F32> rays,
                        ffi::ResultBuffer<ffi::F32> hits,
                        ffi::ResultBuffer<ffi::S32> pops,
                        int32_t stack_depth, int32_t any_hit) {
  auto rdims = rows.dimensions();
  auto ydims = rays.dimensions();
  if (rdims.size() != 2 || rdims[1] != kRowWidth) {
    return ffi::Error::InvalidArgument("rows must be [M, 128] f32");
  }
  if (ydims.size() != 2 || ydims[1] != 8) {
    return ffi::Error::InvalidArgument("rays must be [N, 8] f32");
  }
  if (stack_depth < 1 || stack_depth > 256) {
    return ffi::Error::InvalidArgument("stack_depth must be in [1, 256]");
  }
  const int n = static_cast<int>(ydims[0]);
  if (n == 0) return ffi::Error::Success();
  auto* r = reinterpret_cast<const float4*>(rows.typed_data());
  auto* y = reinterpret_cast<const float4*>(rays.typed_data());
  auto* h = reinterpret_cast<float4*>(hits->typed_data());
  int* p = pops->typed_data();
  if (stack_depth <= 64) {
    if (any_hit) launch<64, true>(stream, r, y, n, stack_depth, h, p);
    else launch<64, false>(stream, r, y, n, stack_depth, h, p);
  } else {
    if (any_hit) launch<256, true>(stream, r, y, n, stack_depth, h, p);
    else launch<256, false>(stream, r, y, n, stack_depth, h, p);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("traverse kernel launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(GptBvhTraverse, TraverseImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("stack_depth")
                                  .Attr<int32_t>("any_hit"));
