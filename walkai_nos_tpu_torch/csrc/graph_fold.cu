// The device-resident loop's graph (models/serve_graph.py): L bodies,
// each body i >= 1 inside a conditional IF node that runs it only while
// a device flag the previous body wrote is true.
//
//   body 0 -> set(h1, go) -> IF h1 { body 1 } -> set(h2, go) -> IF h2 { body 2 } ...
//
// The bodies are graphs captured by PyTorch (one capture each, sharing a
// memory pool); each is cloned into the parent as a child graph node.
// `set_conditional` copies the flag into the node's handle: a body that
// did not run leaves the flag false, so every later body is skipped too.
//
// Plain C interface, loaded with ctypes. Needs CUDA 12.4 or newer
// (conditional nodes, child graphs inside their bodies).

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle,
                                const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

}  // namespace

extern "C" {

// bodies: n captured graphs (cudaGraph_t) in order; go: the device flag
// (one bool). On success *exec_out holds the instantiated graph.
int graph_fold_build(void** bodies, int n, const bool* go, void** exec_out) {
  cudaGraph_t parent = nullptr;
  cudaError_t err = cudaGraphCreate(&parent, 0);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t prev = nullptr;
  err = cudaGraphAddChildGraphNode(&prev, parent, nullptr, 0,
                                   static_cast<cudaGraph_t>(bodies[0]));
  for (int i = 1; i < n && err == cudaSuccess; ++i) {
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, parent, 0, 0);
    if (err != cudaSuccess) break;
    void* args[] = {&handle, &go};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(set_conditional);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    cudaGraphNode_t set = nullptr;
    err = cudaGraphAddKernelNode(&set, parent, &prev, 1, &kp);
    if (err != cudaSuccess) break;
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    cudaGraphNode_t cond = nullptr;
#if CUDART_VERSION >= 13000
    err = cudaGraphAddNode(&cond, parent, &set, nullptr, 1, &cp);
#else
    err = cudaGraphAddNode(&cond, parent, &set, 1, &cp);
#endif
    if (err != cudaSuccess) break;
    cudaGraphNode_t child = nullptr;
    err = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0],
                                     nullptr, 0,
                                     static_cast<cudaGraph_t>(bodies[i]));
    prev = cond;
  }
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, parent, 0);
  cudaGraphDestroy(parent);
  if (err != cudaSuccess) return err;
  *exec_out = exec;
  return cudaSuccess;
}

int graph_fold_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

int graph_fold_destroy(void* exec) {
  return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

}  // extern "C"
