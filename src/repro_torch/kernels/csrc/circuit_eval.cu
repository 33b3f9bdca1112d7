// Circuit-program kernel: evaluates a register-allocated gate program
// word-parallel over packed bitmaps.
//
// Replaces the Pallas kernel `_circuit_kernel` of
// src/repro/kernels/threshold_ssum.py (called by `run_circuit_pallas`).
// The reference specialises its kernel per circuit when it is traced; this
// one kernel *interprets* the byte code of `repro_torch.core.bytecode`, so
// one build serves every circuit.
//
// Work per launch: N input rows read once, k output rows written once,
// ~5N bitwise gates per word.  On an H100 that is bound by bytes, not by
// operations -- if the interpreter neither waits for one device-memory read
// per gate nor spends many instructions on decoding one.  So:
//   * each thread owns VEC word columns (block-strided: every load and
//     store is coalesced along the word axis and needs no alignment);
//   * the register file lives in shared memory as [n_regs][VEC][threads]:
//     neighbouring threads hit neighbouring banks, no conflicts;
//   * input rows enter the register file through LOAD instructions that the
//     host schedules in batches, one batch ahead of the gates that use it.
//     A LOAD is an asynchronous copy (cp.async, global -> shared), so many
//     reads are in flight per thread while earlier gates are evaluated
//     (a LOAD that reads and stores right before the first use stalls its
//     warp once per row and measured 40 % slower over 64 rows on an H100);
//     COMMIT closes a batch, WAIT n blocks until at most n batches are in
//     flight.  Rows are addressed by index and row stride: member subsets
//     and strided views are read in place;
//   * every gate operand is a shared-memory slot (constants get a slot of
//     their own, filled by CONST); the program is staged into shared memory a chunk at a time
//     (the block synchronises only there) and read from it with broadcast
//     loads, one int4 per instruction, the next one fetched while the
//     current one executes, decoded once for the thread's VEC columns;
//   * the interpreter is bound by instruction issue, so the host fuses each
//     full adder (5 gates) into one two-word instruction FA, or MAJ when
//     the sum is dead: 3 operand reads, 2 three-input logic ops, 2 stores;
//   * the ragged end of the word axis is masked here: no padded copy.
// A thread reads only the register words it wrote itself.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum : int {
    OP_AND = 0, OP_OR = 1, OP_XOR = 2, OP_ANDNOT = 3, OP_LOAD = 4, OP_COMMIT = 5, OP_WAIT = 6,
    OP_FA = 7, OP_MAJ = 8, OP_EXT = 9, OP_NOP = 10, OP_CONST = 11
};

__device__ __forceinline__ void cp_async_word(uint32_t* dst_shared, const uint32_t* src_global) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src_global) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// instructions staged into shared memory at a time (the device's L1 is
// small beside the shared-memory carve-out and the streamed inputs evict it)
constexpr int PROG_CHUNK = 256;

template <int VEC>
__global__ void circuit_eval_kernel(const uint32_t* __restrict__ in, long long row_stride,
                                    long long n_words, const int4* __restrict__ prog,
                                    int n_instr, const int* __restrict__ outs, int k,
                                    uint32_t* __restrict__ out, long long out_stride) {
    extern __shared__ int4 shared[];
    int4* sprog = shared;                               // [PROG_CHUNK]
    uint32_t* regs = (uint32_t*)(shared + PROG_CHUNK);  // [n_regs][VEC][blockDim.x]
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;
    const int slot_words = VEC * nthr;
    const long long base = (long long)blockIdx.x * slot_words + tid;

    // word offsets of this thread's columns; a column past the end re-reads
    // the last word (its results are never stored)
    long long col[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
        const long long w = base + (long long)v * nthr;
        col[v] = w < n_words ? w : n_words - 1;
    }

    auto fetch = [&](int s, uint32_t (&x)[VEC]) {  // every operand is a slot
        const uint32_t* r = regs + s * slot_words + tid;
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[v] = r[v * nthr];
    };

    for (int c0 = 0; c0 < n_instr; c0 += PROG_CHUNK) {
        const int cnt = min(PROG_CHUNK, n_instr - c0);
        __syncthreads();  // everyone is done with the previous chunk
        for (int i = tid; i < cnt; i += nthr) sprog[i] = __ldg(prog + c0 + i);
        __syncthreads();
        int4 ins = sprog[0];
        for (int i = 0; i < cnt; ++i) {
            int4 nxt = sprog[min(i + 1, cnt - 1)];  // fetched while `ins` executes
            uint32_t* d = regs + ins.y * slot_words + tid;
            if (ins.x == OP_FA || ins.x == OP_MAJ) {
                // a full adder in two words: (op, dst_sum | dst_carry, a, b) (EXT, dst_carry, c, 0);
                // the host never lets the pair straddle a chunk
                uint32_t a[VEC], b[VEC], c[VEC];
                fetch(ins.z, a);
                fetch(ins.w, b);
                fetch(nxt.z, c);
                uint32_t* dc = (ins.x == OP_FA) ? regs + nxt.y * slot_words + tid : d;
                if (ins.x == OP_FA) {
#pragma unroll
                    for (int v = 0; v < VEC; ++v) d[v * nthr] = a[v] ^ b[v] ^ c[v];
                }
#pragma unroll
                for (int v = 0; v < VEC; ++v) dc[v * nthr] = (a[v] & b[v]) | (c[v] & (a[v] ^ b[v]));
                ++i;
                nxt = sprog[min(i + 1, cnt - 1)];
            } else if (ins.x <= OP_ANDNOT) {
                uint32_t a[VEC], b[VEC];
                fetch(ins.z, a);
                fetch(ins.w, b);
                if (ins.x == OP_ANDNOT) {
#pragma unroll
                    for (int v = 0; v < VEC; ++v) b[v] = ~b[v];
                }
                if (ins.x == OP_OR) {
#pragma unroll
                    for (int v = 0; v < VEC; ++v) d[v * nthr] = a[v] | b[v];
                } else if (ins.x == OP_XOR) {
#pragma unroll
                    for (int v = 0; v < VEC; ++v) d[v * nthr] = a[v] ^ b[v];
                } else {  // AND, ANDNOT
#pragma unroll
                    for (int v = 0; v < VEC; ++v) d[v * nthr] = a[v] & b[v];
                }
            } else if (ins.x == OP_LOAD) {
                const uint32_t* row = in + (long long)ins.z * row_stride;
#pragma unroll
                for (int v = 0; v < VEC; ++v) cp_async_word(d + v * nthr, row + col[v]);
            } else if (ins.x == OP_COMMIT) {
                cp_async_commit();
            } else if (ins.x == OP_WAIT) {  // the host keeps at most two batches in flight
                if (ins.z >= 1) cp_async_wait<1>();
                else cp_async_wait<0>();
            } else if (ins.x == OP_CONST) {
#pragma unroll
                for (int v = 0; v < VEC; ++v) d[v * nthr] = (uint32_t)ins.z;
            }  // OP_NOP: nothing
            ins = nxt;
        }
    }

    for (int j = 0; j < k; ++j) {
        uint32_t x[VEC];
        fetch(__ldg(outs + j), x);
        uint32_t* o = out + (long long)j * out_stride + base;
#pragma unroll
        for (int v = 0; v < VEC; ++v)
            if (base + (long long)v * nthr < n_words) o[(long long)v * nthr] = x[v];
    }
}

template <int VEC>
cudaError_t launch(const uint32_t* in, long long row_stride, long long n_words, const int4* prog,
                   int n_instr, const int* outs, int k, uint32_t* out, long long out_stride,
                   int n_regs, int threads, cudaStream_t stream) {
    const size_t smem = PROG_CHUNK * sizeof(int4) + (size_t)n_regs * VEC * threads * sizeof(uint32_t);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(circuit_eval_kernel<VEC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const long long per_block = (long long)threads * VEC;
    const long long blocks = (n_words + per_block - 1) / per_block;
    if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
    circuit_eval_kernel<VEC><<<(unsigned)blocks, threads, smem, stream>>>(
        in, row_stride, n_words, prog, n_instr, outs, k, out, out_stride);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code of the launch (0: ok).
// Never synchronises and allocates nothing.
int circuit_eval_launch(const void* in, long long row_stride, long long n_words, const void* prog,
                        int n_instr, const void* outs, int k, void* out, long long out_stride,
                        int n_regs, int threads, int vec, void* stream) {
    if (n_words <= 0 || k <= 0) return (int)cudaSuccess;
    auto s = (cudaStream_t)stream;
    auto i = (const uint32_t*)in;
    auto p = (const int4*)prog;
    auto o = (const int*)outs;
    auto d = (uint32_t*)out;
    cudaError_t e;
    switch (vec) {
        case 1: e = launch<1>(i, row_stride, n_words, p, n_instr, o, k, d, out_stride, n_regs, threads, s); break;
        case 2: e = launch<2>(i, row_stride, n_words, p, n_instr, o, k, d, out_stride, n_regs, threads, s); break;
        default: e = cudaErrorInvalidValue;
    }
    return (int)e;
}

// Shared memory a block spends on the staged program chunk (bytes).
int circuit_eval_program_bytes() { return PROG_CHUNK * (int)sizeof(int4); }

// Largest dynamic shared memory a block may opt in to on `device` (bytes), or -1.
int circuit_eval_max_shared(int device) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
        return -1;
    return v;
}

const char* circuit_eval_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
