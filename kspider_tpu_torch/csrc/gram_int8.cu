// Weighted Gram tiles from packed membership bits on int8 tensor cores.
//
// Replaces the four Pallas kernels of kspider_tpu/ops/pallas_pairwise.py:
// cooccurrence_pallas (full square), cooccurrence_pallas_rect (two panels),
// cooccurrence_pallas_tri (explicit upper-triangle tile list) and
// cooccurrence_pallas_sym (upper strips, mirrored afterwards).  All four
// compute, over a set of output tiles,
//
//   out[l, i, j] += sum_c bit_i[c, i] * w_l[c] * bit_j[c, j]
//
// and here they are one kernel driven by a tile-pair list: every launch mode
// (all tiles of a rectangle, upper tiles of one panel) is just a list.
//
// Layout (the JAX package's transposed one, colors contiguous):
//   bits   u8[NB, n_pad/8, block]  byte r of color c holds samples 8r..8r+7,
//                                  most significant bit first
//   w      i8[NB, L, block]        base-128 weight limbs, each in [0, 127]
//   out   i32[L, npad_i, npad_j]   accumulated in place (zeroed by the caller)
//
// Design: grid = (tile pairs, limbs); one CTA of 8 warps owns one 128x128
// output tile of one limb and sweeps every color, 128 colors per chunk.
// Per chunk each thread loads two 32-bit words of packed bits per side
// (coalesced, colors contiguous) and unpacks them with shifts straight into
// shared memory as K-major int8 0/1 (the j side multiplied by its limb,
// which stays int8 because limbs are <= 127).  Warps then run wmma
// m16n16k16 s8 x s8 -> s32 products; each warp owns a 32x64 block of the
// tile (8 accumulator fragments).  The next chunk's global words are loaded
// into registers before the products, so the loads overlap the math.
//
// Bound: at the dense engine's shapes (K of ~10^5 colors, 1 KB of packed
// bits per color per side) each packed byte feeds 8 x 128 x 2 int8 MACs,
// far above the card's ops:byte ratio, so the kernel is bound by int8
// tensor-core issue, not by memory.  What this simple design gives up:
// wgmma and TMA (mma.sync-class wmma reaches a fraction of Hopper's int8
// peak), a multi-stage shared-memory ring (one buffer, two barriers per
// chunk), persistence, reuse of one unpacked chunk across limbs (each limb
// is its own CTA and unpacks again), and skipping the lower half of
// diagonal tiles.
//
// Exactness: a limb term is at most 127 per color and the caller bounds the
// colors per accumulation (_MAX_COLORS_PER_CALL), so int32 never wraps.

#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTile = 128;         // output tile edge (samples)
constexpr int kChunk = 128;        // colors per shared-memory chunk
constexpr int kThreads = 256;      // 8 warps
constexpr int kK16 = kChunk / 16;  // wmma k-steps per chunk
// one 16-color panel of an operand: kTile rows x 16 bytes, padded by 32
// bytes so unpack stores spread over the banks and every panel stays
// 32-byte aligned for wmma::load_matrix_sync
constexpr int kPanel = kTile * 16 + 32;
constexpr int kWordsPerSide = (kTile / 8) * kChunk / 4;     // 512
constexpr int kWordsPerThread = kWordsPerSide / kThreads;   // 2

__device__ __forceinline__ void load_chunk(
    const uint32_t* __restrict__ bi, const uint32_t* __restrict__ bj,
    const uint32_t* __restrict__ wl, long long bits_stride_words,
    uint32_t (&ri)[kWordsPerThread], uint32_t (&rj)[kWordsPerThread],
    uint32_t (&rw)[kWordsPerThread]) {
  #pragma unroll
  for (int s = 0; s < kWordsPerThread; ++s) {
    const int q = threadIdx.x + s * kThreads;
    const int r = q / (kChunk / 4);   // byte row: samples 8r..8r+7
    const int kw = q % (kChunk / 4);  // word along colors
    ri[s] = __ldg(bi + r * bits_stride_words + kw);
    rj[s] = __ldg(bj + r * bits_stride_words + kw);
    rw[s] = __ldg(wl + kw);
  }
}

__device__ __forceinline__ void unpack_chunk(
    int8_t* __restrict__ sa, int8_t* __restrict__ sb,
    const uint32_t (&ri)[kWordsPerThread], const uint32_t (&rj)[kWordsPerThread],
    const uint32_t (&rw)[kWordsPerThread]) {
  #pragma unroll
  for (int s = 0; s < kWordsPerThread; ++s) {
    const int q = threadIdx.x + s * kThreads;
    const int r = q / (kChunk / 4);
    const int kw = q % (kChunk / 4);
    const int k = 4 * kw;                       // first of 4 colors
    const int off = (k / 16) * kPanel + (k % 16);
    #pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int row = 8 * r + p;
      // bit (7 - p) of each of the 4 bytes, moved to bit 0 of its byte
      const uint32_t a = (ri[s] >> (7 - p)) & 0x01010101u;
      const uint32_t b = (rj[s] >> (7 - p)) & 0x01010101u;
      *reinterpret_cast<uint32_t*>(sa + off + row * 16) = a;
      *reinterpret_cast<uint32_t*>(sb + off + row * 16) = (b * 0xFFu) & rw[s];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gram_int8_tiles_kernel(const uint8_t* __restrict__ bits_i,
                       const uint8_t* __restrict__ bits_j,
                       const int8_t* __restrict__ wl,
                       const int32_t* __restrict__ tile_i,
                       const int32_t* __restrict__ tile_j,
                       int32_t* __restrict__ out,
                       int n_blocks, int block, int n_limbs,
                       int n8_i, int n8_j, int npad_i, int npad_j) {
  __shared__ __align__(128) int8_t sa[kK16 * kPanel];
  __shared__ __align__(128) int8_t sb[kK16 * kPanel];

  const int pair = blockIdx.x;
  const int limb = blockIdx.y;
  const int ti = tile_i[pair];
  const int tj = tile_j[pair];
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;  // 4 warps down: rows wm*32 .. +32
  const int wn = warp % 2;  // 2 warps across: cols wn*64 .. +64

  int32_t* out_tile = out + (long long)limb * npad_i * npad_j
                      + (long long)(ti * kTile) * npad_j + tj * kTile;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
  #pragma unroll
  for (int m = 0; m < 2; ++m)
    #pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::load_matrix_sync(
          acc[m][n], out_tile + (long long)(wm * 32 + m * 16) * npad_j
                         + wn * 64 + n * 16,
          npad_j, wmma::mem_row_major);

  const int chunks_per_block = block / kChunk;
  const int n_chunks = n_blocks * chunks_per_block;
  // 32-bit word strides of the packed layouts
  const long long bw = block / 4;
  auto side_ptr = [&](const uint8_t* bits, int n8, int t, int chunk) {
    const int b = chunk / chunks_per_block;
    const int c0 = (chunk % chunks_per_block) * kChunk;
    return reinterpret_cast<const uint32_t*>(bits)
           + ((long long)b * n8 + t * (kTile / 8)) * bw + c0 / 4;
  };
  auto limb_ptr = [&](int chunk) {
    const int b = chunk / chunks_per_block;
    const int c0 = (chunk % chunks_per_block) * kChunk;
    return reinterpret_cast<const uint32_t*>(wl)
           + ((long long)b * n_limbs + limb) * bw + c0 / 4;
  };

  uint32_t ri[kWordsPerThread], rj[kWordsPerThread], rw[kWordsPerThread];
  if (n_chunks > 0)
    load_chunk(side_ptr(bits_i, n8_i, ti, 0), side_ptr(bits_j, n8_j, tj, 0),
               limb_ptr(0), bw, ri, rj, rw);

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    __syncthreads();  // previous chunk's products are done with smem
    unpack_chunk(sa, sb, ri, rj, rw);
    __syncthreads();
    if (chunk + 1 < n_chunks)
      load_chunk(side_ptr(bits_i, n8_i, ti, chunk + 1),
                 side_ptr(bits_j, n8_j, tj, chunk + 1), limb_ptr(chunk + 1),
                 bw, ri, rj, rw);

    #pragma unroll
    for (int kk = 0; kk < kK16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb[4];
      const int8_t* pa = sa + kk * kPanel;
      const int8_t* pb = sb + kk * kPanel;
      #pragma unroll
      for (int m = 0; m < 2; ++m)
        wmma::load_matrix_sync(fa[m], reinterpret_cast<const signed char*>(
                                          pa + (wm * 32 + m * 16) * 16), 16);
      #pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::load_matrix_sync(fb[n], reinterpret_cast<const signed char*>(
                                          pb + (wn * 64 + n * 16) * 16), 16);
      #pragma unroll
      for (int m = 0; m < 2; ++m)
        #pragma unroll
        for (int n = 0; n < 4; ++n)
          wmma::mma_sync(acc[m][n], fa[m], fb[n], acc[m][n]);
    }
  }

  #pragma unroll
  for (int m = 0; m < 2; ++m)
    #pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(
          out_tile + (long long)(wm * 32 + m * 16) * npad_j + wn * 64 + n * 16,
          acc[m][n], npad_j, wmma::mem_row_major);
}

}  // namespace

extern "C" {

int ks_gram_tile() { return kTile; }
int ks_gram_chunk() { return kChunk; }

// Launches one CTA per (tile pair, limb).  Shapes are checked by the Python
// wrapper; returns cudaGetLastError() so a refused launch is not silent.
int ks_gram_int8_tiles(const void* bits_i, const void* bits_j, const void* wl,
                       const void* tile_i, const void* tile_j, void* out,
                       int num_pairs, int n_blocks, int block, int n_limbs,
                       int npad_i, int npad_j, void* stream) {
  if (num_pairs > 0 && n_limbs > 0) {
    gram_int8_tiles_kernel<<<dim3(num_pairs, n_limbs), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bits_i), static_cast<const uint8_t*>(bits_j),
        static_cast<const int8_t*>(wl), static_cast<const int32_t*>(tile_i),
        static_cast<const int32_t*>(tile_j), static_cast<int32_t*>(out),
        n_blocks, block, n_limbs, npad_i / 8, npad_j / 8, npad_i, npad_j);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
