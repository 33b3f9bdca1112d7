// Tiled event kernel: the event stage of the tile-skipping `tiled_fused`
// route.  One thread block per event row (one tile of tw words) and batch of
// outputs.
//
// Replaces the reference's jitted XLA `event_runner` of
// src/repro/kernels/tiled_scan.py:295 (there is no Pallas kernel for it),
// which the port ran as about thirty torch ops: a per-wire `cumsum` along the
// toggle axis (PyTorch's outer-dimension scan walks the toggles one after
// another, one thread a wire), two `cummax` forward fills and an
// `index_add_` scatter.
//
// What bounds it.  Each toggle is read once (its in-tile position, uint16,
// and its wire, uint8: 3 bytes), each output tile written once (4 bytes a
// word); the plan's row ranges, group ids, LUT and destinations are a few
// bytes a row.  So the stage is bound by bytes, and at a few hundred toggles
// a tile it is far below any compute limit.  The design keeps everything
// between those reads and writes in shared memory and registers:
//
//   (1) the block zeroes its toggle words kb x tw in shared memory and stages
//       its group's LUT rows for its outputs there (where kb * mm bytes fit
//       LUT_STAGE_BYTES; otherwise the LUT is read through the cache);
//   (2) the row's toggles [row_ptr[row], row_ptr[row + 1]) are read in chunks
//       of the block's threads, one toggle a thread; a block-wide XOR scan of
//       the one-hot wire masks (warp shuffles, then one word a warp in shared
//       memory), carried from chunk to chunk and restarted at the row, gives
//       each toggle the input combination it closes: it replaces both the
//       per-wire cumsum and the row-start lookup of the torch-op version;
//   (3) toggles at one position cancel or combine: only the last toggle of a
//       run of equal positions may fire, and it fires an output where the
//       output's LUT value after the run differs from the value before it
//       (the run's own masks XORed back out; a run may span a chunk).  A
//       fired bit is set in the output's shared toggle words by atomicXor;
//       positions at tw * 32 lie off the tile and are dropped;
//   (4) each warp then takes an output: prefix-XOR inside each word by
//       doubling shifts, word parities scanned by shuffles and carried along
//       the row, the background (LUT entry 0) applied, and the tile stored to
//       its row of the output buffer (coalesced, 128 bytes a warp).
//
// Nothing here depends on the order in which threads run: XOR is
// commutative, and every fired bit is distinct within a tile and output.
// The results are the torch-op version's words (tiled_scan.event_plain) bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
// LUT bytes of a block's outputs staged in shared memory at most (must equal
// tiled_scan.EVENT_LUT_STAGE_BYTES)
constexpr int LUT_STAGE_BYTES = 4096;
// one word of the block's XOR scan per warp, for up to 32 warps
constexpr int WARP_WORDS = 32;
// dynamic shared memory a block takes at most: the default limit, so no
// opt-in is needed (must equal tiled_scan.EVENT_SHARED_BYTES)
constexpr size_t SHARED_LIMIT = 48 * 1024;

// Shared memory of a block, in this order: the toggle words uint32[kb][tw],
// the warp totals uint32[WARP_WORDS], the staged LUT uint8[kb][mm] (only
// where kb * mm <= LUT_STAGE_BYTES).
__host__ __device__ inline bool lut_staged(int kb, int mm) {
    return (long long)kb * mm <= LUT_STAGE_BYTES;
}
__host__ __device__ inline size_t shared_bytes(int tw, int kb, int mm) {
    return (size_t)kb * tw * 4 + WARP_WORDS * 4 + (lut_staged(kb, mm) ? (size_t)kb * mm : 0);
}

__device__ __forceinline__ uint32_t warp_xor_scan(uint32_t x, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, x, d);
        if (lane >= d) x ^= y;
    }
    return x;
}

__global__ void __launch_bounds__(1024) tiled_events_kernel(
        uint32_t* __restrict__ out, const int* __restrict__ row_ptr,
        const uint16_t* __restrict__ pos, const uint8_t* __restrict__ wire,
        const long long* __restrict__ gid_row, const uint8_t* __restrict__ lut,
        const int* __restrict__ dst, int tw, int k_max, int kb, int mm) {
    extern __shared__ uint32_t shared[];
    uint32_t* tog = shared;                              // [kb][tw]
    uint32_t* wtot = tog + (size_t)kb * tw;              // [WARP_WORDS]
    uint8_t* slut = (uint8_t*)(wtot + WARP_WORDS);       // [kb][mm] when staged
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = nthr >> 5;
    const long long row = blockIdx.x;
    const int j0 = blockIdx.y * kb;
    const int nk = min(kb, k_max - j0);
    const uint8_t* glut = lut + ((long long)gid_row[row] * k_max + j0) * mm;
    const bool staged = lut_staged(kb, mm);

    // (1) toggle words to zero, the LUT rows of this block's outputs
    for (int i = tid; i < nk * tw; i += nthr) tog[i] = 0u;
    if (staged)
        for (int i = tid; i < nk * mm; i += nthr) slut[i] = glut[i];
    __syncthreads();
    const uint8_t* L = staged ? slut : glut;

    // (2)-(3) the row's toggles, a chunk of the block's threads at a time
    const int p0 = row_ptr[row], p1 = row_ptr[row + 1];
    const int span = tw * 32;
    const uint32_t cmask = (uint32_t)mm - 1u;
    uint32_t carry = 0u;  // XOR of every earlier chunk's masks
    for (int base = p0; base < p1; base += nthr) {
        const int i = base + tid;
        const bool valid = i < p1;
        const int p = valid ? (int)pos[i] : 0;
        const uint32_t m = valid ? 1u << wire[i] : 0u;
        uint32_t x = warp_xor_scan(m, lane);
        if (lane == 31) wtot[warp] = x;
        __syncthreads();
        uint32_t before = carry;
        for (int w = 0; w < nwarps; ++w) {
            const uint32_t s = wtot[w];
            if (w < warp) before ^= s;
            carry ^= s;
        }
        __syncthreads();  // wtot is written again by the next chunk
        x ^= before;      // the combination after this toggle
        if (valid && p < span && (i + 1 == p1 || (int)pos[i + 1] != p)) {
            // the last toggle at position p: the combination before its run
            uint32_t prev = x ^ m;
            for (int q = i - 1; q >= p0 && (int)pos[q] == p; --q) prev ^= 1u << wire[q];
            const uint32_t a = x & cmask, b = prev & cmask;
            if (a != b) {
                const uint32_t bit = 1u << (p & 31);
                uint32_t* t = tog + (p >> 5);
                for (int j = 0; j < nk; ++j)
                    if (L[j * mm + a] != L[j * mm + b]) atomicXor(t + j * tw, bit);
            }
        }
    }
    __syncthreads();

    // (4) one warp an output: fill the toggled words, apply the background, store
    for (int j = warp; j < nk; j += nwarps) {
        const int d = dst[row * k_max + j0 + j];
        if (d < 0) continue;
        const uint32_t bg = L[j * mm] ? FULL : 0u;
        const uint32_t* t = tog + j * tw;
        uint32_t* o = out + (long long)d * tw;
        uint32_t c = 0u;  // parity of every earlier word of the row
        for (int w0 = 0; w0 < tw; w0 += 32) {
            const int w = w0 + lane;
            uint32_t v = w < tw ? t[w] : 0u;
            v ^= v << 1;
            v ^= v << 2;
            v ^= v << 4;
            v ^= v << 8;
            v ^= v << 16;
            const uint32_t par = v >> 31;
            const uint32_t inc = warp_xor_scan(par, lane);
            v ^= 0u - (inc ^ par ^ c);
            if (w < tw) o[w] = v ^ bg;
            c ^= __shfl_sync(FULL, inc, 31);
        }
    }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code of the launch (0: ok):
// a grid of n_rows x ceil(k_max / kb) blocks of `threads` threads.  Never
// synchronises and allocates nothing.
int tiled_events_launch(void* out, const void* row_ptr, const void* pos, const void* wire,
                        const void* gid_row, const void* lut, const void* dst, int n_rows,
                        int tw, int k_max, int kb, int mm, int threads, void* stream) {
    if (n_rows <= 0 || k_max <= 0) return (int)cudaSuccess;
    if (threads <= 0 || threads % 32 != 0 || threads > WARP_WORDS * 32 || kb <= 0 || tw <= 0 ||
        mm <= 0 || (mm & (mm - 1)) != 0)
        return (int)cudaErrorInvalidValue;
    const int n_batches = (k_max + kb - 1) / kb;
    if (n_batches > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = shared_bytes(tw, kb, mm);
    if (smem > SHARED_LIMIT) return (int)cudaErrorInvalidValue;
    tiled_events_kernel<<<dim3((unsigned)n_rows, (unsigned)n_batches), threads, smem,
                          (cudaStream_t)stream>>>(
        (uint32_t*)out, (const int*)row_ptr, (const uint16_t*)pos, (const uint8_t*)wire,
        (const long long*)gid_row, (const uint8_t*)lut, (const int*)dst, tw, k_max, kb, mm);
    return (int)cudaGetLastError();
}

// Dynamic shared memory one block of this shape takes (bytes); the wrapper
// holds its own count of the same layout against it.
long long tiled_events_shared_bytes(int tw, int kb, int mm) {
    return (long long)shared_bytes(tw, kb, mm);
}

const char* tiled_events_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
