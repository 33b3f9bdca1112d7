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
//   * each thread owns VEC (1, 2 or 4) consecutive word columns, and the
//     register file lives in shared memory as [n_regs][threads][VEC]: one
//     VEC*4-byte shared-memory access reads or writes an operand, and a
//     warp's access covers consecutive banks (no conflicts).  The decode of
//     an instruction, its address arithmetic and its load/store
//     instructions are paid once for VEC words: the per-word instruction
//     count is what binds the interpreter (PERF.md);
//   * input rows enter the register file through LOAD instructions that the
//     host schedules in batches, one batch ahead of the gates that use it.
//     A LOAD is an asynchronous copy (cp.async, global -> shared): one
//     VEC*4-byte copy where every row starts on a VEC-word boundary (base
//     pointer and row stride), zero-filled past the end of the word axis,
//     else VEC 4-byte copies of clamped columns.  COMMIT closes a batch,
//     WAIT n blocks until at most n batches are in flight.  Rows are
//     addressed by index and row stride: member subsets and strided views
//     are read in place.  A run of LOADs is issued by one tight loop, not
//     one interpreter turn per row;
//   * every gate operand is a shared-memory slot (constants get a slot of
//     their own, filled by CONST); the program is staged into shared memory
//     a chunk at a time (the block synchronises only there), its slot
//     fields turned into byte offsets on the way, and read from it with
//     broadcast loads, the next two words fetched while the current
//     instruction executes;
//   * a full adder (5 gates) is one two-word instruction FA, or MAJ when
//     the sum is dead: 3 operand reads, 2 three-input logic ops, 2 stores;
//   * the ragged end of the word axis is masked here: no padded copy;
//   * the dynamic shared-memory ceiling is raised once per device, never
//     per launch.
// A thread reads only the register words it wrote itself.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

enum : int {
    OP_AND = 0, OP_OR = 1, OP_XOR = 2, OP_ANDNOT = 3, OP_LOAD = 4, OP_COMMIT = 5, OP_WAIT = 6,
    OP_FA = 7, OP_MAJ = 8, OP_EXT = 9, OP_NOP = 10, OP_CONST = 11
};
// instructions staged into shared memory at a time (the device's L1 is
// small beside the shared-memory carve-out and the streamed inputs evict it)
constexpr int PROG_CHUNK = 256;

template <int VEC>
struct Words {
    uint32_t w[VEC];
};

// this thread's VEC words of a slot, in one shared-memory access
template <int VEC>
__device__ __forceinline__ Words<VEC> lds(const uint32_t* p) {
    Words<VEC> x;
    if constexpr (VEC == 4) {
        const uint4 t = *reinterpret_cast<const uint4*>(p);
        x.w[0] = t.x; x.w[1] = t.y; x.w[2] = t.z; x.w[3] = t.w;
    } else if constexpr (VEC == 2) {
        const uint2 t = *reinterpret_cast<const uint2*>(p);
        x.w[0] = t.x; x.w[1] = t.y;
    } else {
        x.w[0] = *p;
    }
    return x;
}
template <int VEC>
__device__ __forceinline__ void sts(uint32_t* p, const Words<VEC>& x) {
    if constexpr (VEC == 4) {
        *reinterpret_cast<uint4*>(p) = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
    } else if constexpr (VEC == 2) {
        *reinterpret_cast<uint2*>(p) = make_uint2(x.w[0], x.w[1]);
    } else {
        *p = x.w[0];
    }
}

__device__ __forceinline__ void cp_async_word(uint32_t* dst_shared, const uint32_t* src_global) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src_global) : "memory");
}
// BYTES from `src` (src_bytes of them; the rest of the BYTES is zero-filled)
template <int BYTES>
__device__ __forceinline__ void cp_async_words(uint32_t* dst_shared, const uint32_t* src_global,
                                               int src_bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src_global),
                     "r"(src_bytes) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src_global),
                     "n"(BYTES), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

template <int VEC>
__global__ void circuit_eval_kernel(const uint32_t* __restrict__ in, long long row_stride,
                                    long long n_words, const int4* __restrict__ prog,
                                    int n_instr, const int* __restrict__ outs, int k,
                                    uint32_t* __restrict__ out, long long out_stride) {
    using W = Words<VEC>;
    extern __shared__ int4 shared[];
    int4* sprog = shared;  // [PROG_CHUNK]
    const int slot_words = VEC * blockDim.x;
    // word v of slot s: mine[s * slot_words + v]; the staged program holds
    // each slot as its byte offset s * slot_bytes from `mine`
    uint32_t* mine = reinterpret_cast<uint32_t*>(shared + PROG_CHUNK) + threadIdx.x * VEC;
    const int slot_bytes = slot_words * 4;
    auto slot = [&](int off) { return reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(mine) + off); };
    const long long col = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
    const long long left = n_words - col;  // this thread's columns before the end (<= 0: none)
    // a LOAD copies VEC words at once where every row starts on a VEC-word
    // boundary (zero-filling past the end), else word by word from clamped
    // columns (a column past the end re-reads the last word; its results are
    // never stored)
    const bool whole = VEC > 1 && reinterpret_cast<uintptr_t>(in) % (VEC * 4) == 0 &&
                       row_stride % VEC == 0;
    const int src_bytes = left >= VEC ? VEC * 4 : (left > 0 ? (int)left * 4 : 0);
    long long at[VEC];  // word offsets of the copies within a row
#pragma unroll
    for (int v = 0; v < VEC; ++v) at[v] = whole ? (left > 0 ? col : 0) : min(col + v, n_words - 1);

    for (int c0 = 0; c0 < n_instr; c0 += PROG_CHUNK) {
        const int cnt = min(PROG_CHUNK, n_instr - c0);
        __syncthreads();  // everyone is done with the previous chunk
        for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
            // slot fields become byte offsets: an operand's address is then one add
            int4 w = __ldg(prog + c0 + i);
            if (w.x <= OP_ANDNOT || w.x == OP_FA || w.x == OP_MAJ) {
                w.y *= slot_bytes; w.z *= slot_bytes; w.w *= slot_bytes;
            } else if (w.x == OP_LOAD || w.x == OP_CONST) {
                w.y *= slot_bytes;
            } else if (w.x == OP_EXT) {
                w.y *= slot_bytes; w.z *= slot_bytes;
            }
            sprog[i] = w;
        }
        __syncthreads();
        int4 ins = sprog[0];
        for (int i = 0; i < cnt; ++i) {
            // the next two words, fetched while `ins` executes: a full
            // adder's second word and the instruction after it
            int4 nxt = sprog[min(i + 1, cnt - 1)];
            const int4 after = sprog[min(i + 2, cnt - 1)];
            if (ins.x == OP_FA || ins.x == OP_MAJ) {
                // a full adder in two words: (op, dst_sum | dst_carry, a, b) (EXT, dst_carry, c, 0);
                // the host never lets the pair straddle a chunk
                const W a = lds<VEC>(slot(ins.z)), b = lds<VEC>(slot(ins.w)), c = lds<VEC>(slot(nxt.z));
                W sum, carry;
#pragma unroll
                for (int v = 0; v < VEC; ++v) {
                    const uint32_t h = a.w[v] ^ b.w[v];
                    sum.w[v] = h ^ c.w[v];
                    carry.w[v] = (a.w[v] & b.w[v]) | (c.w[v] & h);
                }
                if (ins.x == OP_FA) {
                    sts<VEC>(slot(ins.y), sum);
                    sts<VEC>(slot(nxt.y), carry);
                } else {
                    sts<VEC>(slot(ins.y), carry);
                }
                ++i;
                nxt = after;
            } else if (ins.x == OP_LOAD) {
                // the host emits a batch's LOADs back to back: issue the run in
                // one tight loop instead of one interpreter turn each
                for (;;) {
                    const uint32_t* row = in + (long long)ins.z * row_stride;
                    uint32_t* d = slot(ins.y);
                    if (whole) {
                        cp_async_words<VEC * 4>(d, row + at[0], src_bytes);
                    } else {
#pragma unroll
                        for (int v = 0; v < VEC; ++v) cp_async_word(d + v, row + at[v]);
                    }
                    if (nxt.x != OP_LOAD || i + 1 >= cnt) break;
                    ++i;
                    ins = nxt;
                    nxt = sprog[min(i + 1, cnt - 1)];
                }
            } else if (ins.x <= OP_ANDNOT) {
                const W a = lds<VEC>(slot(ins.z)), b = lds<VEC>(slot(ins.w));
                W x;
                if (ins.x == OP_OR) {
#pragma unroll
                    for (int v = 0; v < VEC; ++v) x.w[v] = a.w[v] | b.w[v];
                } else if (ins.x == OP_XOR) {
#pragma unroll
                    for (int v = 0; v < VEC; ++v) x.w[v] = a.w[v] ^ b.w[v];
                } else if (ins.x == OP_AND) {
#pragma unroll
                    for (int v = 0; v < VEC; ++v) x.w[v] = a.w[v] & b.w[v];
                } else {
#pragma unroll
                    for (int v = 0; v < VEC; ++v) x.w[v] = a.w[v] & ~b.w[v];
                }
                sts<VEC>(slot(ins.y), x);
            } else if (ins.x == OP_COMMIT) {
                cp_async_commit();
            } else if (ins.x == OP_WAIT) {  // the host keeps at most two batches in flight
                if (ins.z >= 1) cp_async_wait<1>();
                else cp_async_wait<0>();
            } else if (ins.x == OP_CONST) {
                W x;
#pragma unroll
                for (int v = 0; v < VEC; ++v) x.w[v] = (uint32_t)ins.z;
                sts<VEC>(slot(ins.y), x);
            }  // OP_NOP: nothing
            ins = nxt;
        }
    }

    for (int j = 0; j < k; ++j) {
        const W x = lds<VEC>(slot(__ldg(outs + j) * slot_bytes));
        uint32_t* o = out + (long long)j * out_stride + col;
        if (left >= VEC && reinterpret_cast<uintptr_t>(o) % (VEC * 4) == 0) {
            if constexpr (VEC == 4) *reinterpret_cast<uint4*>(o) = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
            else if constexpr (VEC == 2) *reinterpret_cast<uint2*>(o) = make_uint2(x.w[0], x.w[1]);
            else *o = x.w[0];
        } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v)
                if (v < left) o[v] = x.w[v];
        }
    }
}

// Raises the kernel's dynamic shared-memory ceiling to the card's opt-in
// maximum, once per device (the ceiling is only a limit: each launch still
// takes the size it asks for, and nothing here lowers it again).
template <int VEC>
cudaError_t raise_shared_ceiling() {
    static std::atomic<unsigned long long> raised{0};  // bit d: device d done
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (raised.load(std::memory_order_relaxed) & bit) return cudaSuccess;
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(circuit_eval_kernel<VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
    return e;
}

template <int VEC>
cudaError_t launch(const uint32_t* in, long long row_stride, long long n_words, const int4* prog,
                   int n_instr, const int* outs, int k, uint32_t* out, long long out_stride,
                   int n_regs, int threads, cudaStream_t stream) {
    cudaError_t e = raise_shared_ceiling<VEC>();
    if (e != cudaSuccess) return e;
    const size_t smem = PROG_CHUNK * sizeof(int4) + (size_t)n_regs * VEC * threads * sizeof(uint32_t);
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
    if (threads <= 0 || threads % 32 != 0 || threads > 1024) return (int)cudaErrorInvalidValue;
    auto s = (cudaStream_t)stream;
    auto i = (const uint32_t*)in;
    auto p = (const int4*)prog;
    auto o = (const int*)outs;
    auto d = (uint32_t*)out;
    cudaError_t e;
    switch (vec) {
        case 1: e = launch<1>(i, row_stride, n_words, p, n_instr, o, k, d, out_stride, n_regs, threads, s); break;
        case 2: e = launch<2>(i, row_stride, n_words, p, n_instr, o, k, d, out_stride, n_regs, threads, s); break;
        case 4: e = launch<4>(i, row_stride, n_words, p, n_instr, o, k, d, out_stride, n_regs, threads, s); break;
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
