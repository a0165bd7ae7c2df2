// CUDA-graph conditional IF nodes for a capture that PyTorch has open,
// built by ops/build.py graph_library() into a library of its own.
//
// A capped while loop of the JAX package (`lax.while_loop`) runs on the card
// as a chain of IF nodes, each guarding one block of gated iterations
// (utils/graphs.py `while_blocks`, drive "chain").  `laf_if_begin` adds one
// node to the graph that `outer` is capturing:
//
//   1. a one-thread kernel, captured on `outer`, that sets the node's
//      condition from the bool at `pred` (device memory, read each time the
//      graph runs, so the predicate is whatever the graph computed there);
//   2. the IF node itself, after that kernel, as the capture's new
//      dependency: what `outer` captures next runs after the node;
//   3. the capture of `body` (a stream that is not capturing) into the
//      node's body graph, until `laf_if_end(body)`.
//
// The node runs its body when the condition is nonzero and skips it
// otherwise; the handle has no default, so the kernel sets it at every
// launch of the graph.
//
// `laf_stamp` launches a one-thread kernel on `stream` that reads the
// card's nanosecond clock (%globaltimer) and writes (id, ns) into slot
// atomicAdd(head, 1) of a ring of `cap` slots (utils/profiling.py `spans`).
// Past `cap` it writes nothing but `head` keeps counting, so an overflow
// shows.  Launched eagerly it stamps at once; on a stream that is capturing
// it becomes a node of the graph, or of a conditional body.
//
// Each entry point returns 0 or the cudaError_t of the first call that
// failed.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_condition(cudaGraphConditionalHandle handle, const bool* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

__global__ void laf_stamp_kernel(long long* buf, unsigned long long* head, long long cap, long long id) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    unsigned long long slot = atomicAdd(head, 1ull);
    if (slot < static_cast<unsigned long long>(cap)) {
        buf[2 * slot] = id;
        buf[2 * slot + 1] = static_cast<long long>(ns);
    }
}

}  // namespace

extern "C" int laf_if_begin(cudaStream_t outer, const void* pred, cudaStream_t body) {
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n_deps;
    cudaError_t err = cudaStreamGetCaptureInfo(outer, &status, nullptr, &graph, nullptr, nullptr);
    if (err != cudaSuccess) return err;
    if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return err;
    set_if_condition<<<1, 1, 0, outer>>>(handle, static_cast<const bool*>(pred));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaStreamGetCaptureInfo(outer, &status, nullptr, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return err;
    err = cudaStreamUpdateCaptureDependencies(outer, &node, 1, cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return err;
    return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                         cudaStreamCaptureModeRelaxed);
}

extern "C" int laf_if_end(cudaStream_t body) {
    cudaGraph_t graph;
    return cudaStreamEndCapture(body, &graph);
}

extern "C" int laf_stamp(void* buf, void* head, long long cap, long long id, cudaStream_t stream) {
    laf_stamp_kernel<<<1, 1, 0, stream>>>(static_cast<long long*>(buf), static_cast<unsigned long long*>(head),
                                          cap, id);
    return cudaGetLastError();
}
