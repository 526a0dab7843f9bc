// Weighted Gram tiles from packed membership bits, int8 form, on Hopper's
// warpgroup tensor-core products (wgmma).
//
// Replaces the int8 form of the four Pallas kernels of
// kspider_tpu/ops/pallas_pairwise.py: cooccurrence_pallas (full square),
// cooccurrence_pallas_rect (two panels), cooccurrence_pallas_tri (explicit
// upper-triangle tile list) and cooccurrence_pallas_sym (upper strips,
// mirrored afterwards).  All four compute, over a set of output tiles,
//
//   out[l, i, j] += sum_c bit_i[c, i] * w_l[c] * bit_j[c, j]
//
// and here they are one kernel driven by a list of 128x128 tile pairs:
// every launch mode (all tiles of a rectangle, upper tiles of one panel, any
// other list) is just a list.  The body, its layout and its design are
// shared with the bf16 form (csrc/gram_bf16.cu) in csrc/gram_wgmma.cuh;
// this file is the int8 form's part of it.
//
// Bound: operations.  Each packed byte feeds 8 x 128 x 2 MACs per limb, far
// above the card's ops:byte ratio, so the kernel is bound by the tensor
// cores (1,979 int8 TOP/s dense on an H100 SXM), not by memory.
//
// The form: 128-color chunks (one 128-byte s8 B row per sample), wgmma
// m64n128k32 s8 x s8 -> s32, A built from the packed words with
// (word >> (7 - p)) & 0x01010101 (4 colors' bits of sample p as 4 bytes)
// times 0xFF masking the 4 limb bytes, and a 4-stage ring.
//
// On an H100 (700 W) this reaches 53-56% of the int8 bound at the main
// path's shapes.  What holds it there is shared memory, shared by the
// products' B reads (64 KB a chunk at L = 2) and the unpack and A build;
// a deeper product queue needs a third A register set, which does not fit
// beside 128 accumulators (246 of 255 registers).
//
// Exactness: a limb term is at most 127 per color and the caller bounds the
// colors per accumulation (_MAX_COLORS_PER_CALL), so int32 never wraps.

#include <cstdint>
#include <cuda_runtime.h>

#include "gram_wgmma.cuh"

namespace {

using namespace gram;

// d[64] = A (64x32 s8, registers) . B (32x128 s8, shared memory)
//         + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n128k32(uint32_t (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b,
                                                 uint32_t accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

struct Int8Form {
  using Acc = uint32_t;
  static constexpr int kChunk = 128;   // colors per chunk: one 128-byte B row
  static constexpr int kKSteps = kChunk / 32;             // wgmma k32 steps
  static constexpr int kStages = 4;    // packed-input ring depth
  static constexpr int kSideBytes = (kTile / 8) * kChunk;  // bits of one side
  // a ring stage: i bits, j bits, two limb rows
  static constexpr int kLimbs = 2 * kSideBytes;
  static constexpr int kStageBytes = kLimbs + 2 * kChunk;
  static constexpr int kPrepAhead = 1;
  static constexpr bool kSegments = false;

  static __device__ __forceinline__ void mma(uint32_t (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b,
                                             uint32_t accumulate) {
    wgmma_m64n128k32(d, a, desc_b, accumulate);
  }

  // Unpacks the j side of one stage (16 byte rows x 128 colors) into B: row
  // n = 8r + p holds bit (7 - p) of byte row r, one byte per color, with the
  // 16-byte column group c stored at group c ^ (n % 8).  Each thread turns 16
  // colors of one byte row into 4 of its 8 sample rows.
  static __device__ __forceinline__ void unpack_b(
      const uint8_t* __restrict__ jbits, uint8_t* __restrict__ b) {
    const int u = threadIdx.x % 128;
    const int r = u / 8;           // byte row
    const int grp = u % 8;         // 16-color group
    const int p0 = 4 * (threadIdx.x / 128);
    const uint4 w = *reinterpret_cast<const uint4*>(jbits + r * kChunk + grp * 16);
    #pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      const int p = p0 + pp;
      const int sh = 7 - p;
      uint4 v;
      v.x = (w.x >> sh) & 0x01010101u;
      v.y = (w.y >> sh) & 0x01010101u;
      v.z = (w.z >> sh) & 0x01010101u;
      v.w = (w.w >> sh) & 0x01010101u;
      *reinterpret_cast<uint4*>(b + (8 * r + p) * kChunk + ((grp ^ p) * 16)) = v;
    }
  }

  // This thread's A fragments of one stage, for each k32 step and limb.  In
  // wgmma's 8-bit A layout a warp holds 16 rows x 32 colors: lane 4g + t has
  // row g in registers 0 and 2, row g + 8 in 1 and 3, colors 4t..4t+3 in 0
  // and 1, 16 + 4t..16 + 4t + 3 in 2 and 3, one byte per color (lowest color
  // in the lowest byte, as in the packed words).  Rows g and g + 8 of warp w
  // in warpgroup h are bit (7 - g) of byte rows 8h + 2w and 8h + 2w + 1.
  template <int G>
  static __device__ __forceinline__ void build_a(
      const uint8_t* __restrict__ stage, uint32_t (&a)[kKSteps][G][4]) {
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 2 * (threadIdx.x / 32);  // 8h + 2w
    const int sh = 7 - g;
    const uint8_t* ibits = stage;
    const uint8_t* limbs = stage + kLimbs;
    #pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      const int lo = 32 * s + 4 * t, hi = lo + 16;
      uint32_t m[4];
      m[0] = *reinterpret_cast<const uint32_t*>(ibits + r0 * kChunk + lo);
      m[1] = *reinterpret_cast<const uint32_t*>(ibits + (r0 + 1) * kChunk + lo);
      m[2] = *reinterpret_cast<const uint32_t*>(ibits + r0 * kChunk + hi);
      m[3] = *reinterpret_cast<const uint32_t*>(ibits + (r0 + 1) * kChunk + hi);
      #pragma unroll
      for (int e = 0; e < 4; ++e) m[e] = ((m[e] >> sh) & 0x01010101u) * 0xFFu;
      #pragma unroll
      for (int l = 0; l < G; ++l) {
        const uint32_t wlo = *reinterpret_cast<const uint32_t*>(limbs + l * kChunk + lo);
        const uint32_t whi = *reinterpret_cast<const uint32_t*>(limbs + l * kChunk + hi);
        a[s][l][0] = m[0] & wlo;
        a[s][l][1] = m[1] & wlo;
        a[s][l][2] = m[2] & whi;
        a[s][l][3] = m[3] & whi;
      }
    }
  }

  // out[0], out[1] += x, y (int32 read-add-write)
  static __device__ __forceinline__ void add_out(int32_t* p, uint32_t x,
                                                 uint32_t y) {
    asm volatile(
        "{\n"
        ".reg .s32 u, v;\n"
        "ld.global.v2.s32 {u, v}, [%0];\n"
        "add.s32 u, u, %1;\n"
        "add.s32 v, v, %2;\n"
        "st.global.v2.s32 [%0], {u, v};\n"
        "}\n"
        :: "l"(p), "r"(x), "r"(y) : "memory");
  }
};

// One launch for any L (kPairs: L >= 2).
template <bool kPairs>
__global__ void __launch_bounds__(kThreads, 1)
gram_int8_wgmma_kernel(const Args a) {
  gram_kernel<Int8Form, kPairs>(a);
}

}  // namespace

extern "C" {

int ks_gram_tile() { return kTile; }
int ks_gram_chunk() { return Int8Form::kChunk; }

// One kernel launch for any L.  Shapes are checked by the Python wrapper;
// returns the first CUDA error, so a refused launch is not silent.
int ks_gram_int8_tiles(const void* bits_i, const void* bits_j, const void* wl,
                       const void* tile_i, const void* tile_j, void* out,
                       int num_pairs, int n_blocks, int block, int n_limbs,
                       int npad_i, int npad_j, void* stream) {
  if (num_pairs <= 0 || n_limbs <= 0 || n_blocks <= 0 || block < Int8Form::kChunk)
    return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<const uint8_t*>(bits_i),
               static_cast<const uint8_t*>(bits_j),
               static_cast<const int8_t*>(wl),
               static_cast<const int32_t*>(tile_i),
               static_cast<const int32_t*>(tile_j),
               static_cast<int32_t*>(out),
               num_pairs, n_blocks, block, n_limbs, npad_i, npad_j, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n_limbs >= 2
      ? launch<Int8Form>(gram_int8_wgmma_kernel<true>, a, st)
      : launch<Int8Form>(gram_int8_wgmma_kernel<false>, a, st);
}

}  // extern "C"
