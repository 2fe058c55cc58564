// Device programs of captured segments and while loops: the port's
// counterpart of the JAX package's jitted `lax.while_loop`s
// (diffcloth_tpu/core/step.py:626 the PD loop, :774 the adjoint's fixed
// point, :754 the GMRES cycles).
//
// A program is one CUDA graph built here from graphs captured by PyTorch:
// a chain of child-graph nodes (straight segments) and while loops.  A loop
// is a kernel node that reads the loop's predicate, then a WHILE conditional
// node whose body is the captured block (a child graph) followed by a kernel
// node that reads the predicate again.  The predicate is "any episode still
// active": `go`, a (n,) byte array the captured code keeps up to date, read
// on the device, so the loop ends without the host.  `cap` bounds the body's
// runs per launch; `runs` counts them (runs[0]), the loop's entries
// (runs[1]) and the nanoseconds spent inside the loop (runs[2]: from its
// entry to the end of its last body run, on %globaltimer) over every launch,
// for the host to read when it chooses; runs[3] holds the entry's stamp.
//
// Plain C interface for ctypes; every function returns a cudaError_t.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__device__ unsigned any_active(const uint8_t* go, int n) {
  int any = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) any |= go[i] != 0;
  return (unsigned)__syncthreads_or(any);
}

// before the loop: zero the launch's run count, stamp the entry, enter when
// any is active
__global__ void loop_enter(cudaGraphConditionalHandle h, const uint8_t* go,
                           int n, int cap, int* iter, long long* runs) {
  const unsigned any = any_active(go, n);
  if (threadIdx.x == 0) {
    iter[0] = 0;
    runs[1] += 1;
    runs[3] = global_ns();
    cudaGraphSetConditional(h, any && cap > 0);
  }
}

// after each run of the body: count it, go on while any is active and the
// cap is not reached; the run that ends the loop adds its time since entry
__global__ void loop_next(cudaGraphConditionalHandle h, const uint8_t* go,
                          int n, int cap, int* iter, long long* runs) {
  const unsigned any = any_active(go, n);
  if (threadIdx.x == 0) {
    const int it = ++iter[0];
    const bool more = any && it < cap;
    runs[0] += 1;
    if (!more) runs[2] += global_ns() - runs[3];
    cudaGraphSetConditional(h, more);
  }
}

cudaError_t add_cond_kernel(void* fn, cudaGraph_t graph,
                            const cudaGraphNode_t* deps, size_t n_deps,
                            cudaGraphConditionalHandle h, const uint8_t* go,
                            int n, int cap, int* iter, long long* runs,
                            cudaGraphNode_t* node) {
  void* args[] = {&h, &go, &n, &cap, &iter, &runs};
  cudaKernelNodeParams kp = {};
  kp.func = fn;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(kThreads);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &kp);
}

}  // namespace

extern "C" {

// An empty program graph.
int gp_create(void** graph) {
  cudaGraph_t g = nullptr;
  const cudaError_t err = cudaGraphCreate(&g, 0);
  *graph = g;
  return (int)err;
}

// Appends a straight segment: a child node holding a copy of `child` (a
// captured graph), after `dep` (null: none).
int gp_add_child(void* graph, void* dep, void* child, void** node) {
  cudaGraphNode_t d = (cudaGraphNode_t)dep, out = nullptr;
  const cudaError_t err = cudaGraphAddChildGraphNode(
      &out, (cudaGraph_t)graph, d ? &d : nullptr, d ? 1 : 0,
      (cudaGraph_t)child);
  *node = out;
  return (int)err;
}

// Appends a while loop after `dep`: enter when any of go[0..n) is set, run
// `body` (a captured graph, copied), repeat while any is set and fewer than
// `cap` runs were made in this launch.  iter (1 int) and runs (4 long long)
// are device memory that outlives the program.
int gp_add_loop(void* graph, void* dep, void* body, const uint8_t* go, int n,
                int cap, int* iter, long long* runs, void** node) {
  cudaGraph_t g = (cudaGraph_t)graph;
  cudaGraphNode_t d = (cudaGraphNode_t)dep;
  cudaGraphConditionalHandle h;
  cudaError_t err = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t enter = nullptr;
  err = add_cond_kernel((void*)loop_enter, g, d ? &d : nullptr, d ? 1 : 0,
                        h, go, n, cap, iter, runs, &enter);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = h;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop = nullptr;
  err = cudaGraphAddNode(&loop, g, &enter, 1, &cp);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t inner = cp.conditional.phGraph_out[0];
  cudaGraphNode_t run = nullptr, next = nullptr;
  err = cudaGraphAddChildGraphNode(&run, inner, nullptr, 0,
                                   (cudaGraph_t)body);
  if (err != cudaSuccess) return (int)err;
  err = add_cond_kernel((void*)loop_next, inner, &run, 1, h, go, n, cap,
                        iter, runs, &next);
  *node = loop;
  return (int)err;
}

int gp_instantiate(void* graph, void** exec) {
  cudaGraphExec_t e = nullptr;
  const cudaError_t err = cudaGraphInstantiate(&e, (cudaGraph_t)graph, 0);
  *exec = e;
  return (int)err;
}

int gp_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

int gp_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph) {
    const cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
    if (err == cudaSuccess) err = e2;
  }
  return (int)err;
}

}  // extern "C"
