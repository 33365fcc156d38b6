// The IF node of a captured CUDA graph (CUDA 12.4+ conditional nodes), for
// the step program's line-search trial (training/step_program.py: if_node).
//
// Replaces no TPU kernel: the JAX package's zoom line search is a
// lax.while_loop inside its jitted L-BFGS step, and XLA runs the loop's
// condition on the device. The port replays one captured trial per step of
// the search; the trial's body sits under an IF node whose condition a
// kernel of this file sets from a device flag at each replay, so a trial the
// search does not need runs nothing but that kernel.
//
// gc_begin_if, while a stream captures a graph: creates the node's handle,
// captures the kernel that sets the condition from *pred, adds the IF node
// after it, makes the node the capturing stream's only dependency, and
// starts capturing a second stream into the node's body graph. gc_end ends
// that capture. What the body stream captures in between is the body; the
// caller routes its allocations to a memory pool of its own.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// Loads the module (lazy loading would load it inside the first capture).
extern "C" int gc_load() {
    cudaFuncAttributes attr;
    return (int)cudaFuncGetAttributes(&attr, set_if_kernel);
}

extern "C" int gc_begin_if(void* outer, const bool* pred, void* body) {
    cudaStream_t so = (cudaStream_t)outer, sb = (cudaStream_t)body;
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t ndeps = 0;
    cudaError_t e = cudaStreamGetCaptureInfo(so, &status, nullptr, &graph, &deps, &ndeps);
    if (e != cudaSuccess) return (int)e;
    if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureImplicit;
    cudaGraphConditionalHandle handle;
    e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (e != cudaSuccess) return (int)e;
    set_if_kernel<<<1, 1, 0, so>>>(handle, pred);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = cudaStreamGetCaptureInfo(so, &status, nullptr, &graph, &deps, &ndeps);
    if (e != cudaSuccess) return (int)e;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
    if (e != cudaSuccess) return (int)e;
    e = cudaStreamUpdateCaptureDependencies(so, &node, 1, cudaStreamSetCaptureDependencies);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaStreamBeginCaptureToGraph(sb, params.conditional.phGraph_out[0], nullptr,
                                              nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int gc_end(void* body) {
    cudaGraph_t graph;
    return (int)cudaStreamEndCapture((cudaStream_t)body, &graph);
}

