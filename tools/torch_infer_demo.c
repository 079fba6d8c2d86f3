/* Plain-C serving consumer for paddle_tpu_torch saved programs.
 *
 * Reference parity: the demo programs of paddle/fluid/inference/capi_exp/
 * — a C-only process serving a saved model with no Python in the source.
 *
 * Usage:
 *   torch_infer_demo <libpaddle_tpu_torch_infer.so> <artifact_prefix> \
 *                    <input.bin> <d0> [d1 ...]
 * Reads float32s from input.bin with the given shape, runs one inference,
 * and prints the output shape + float32 values (one per line) on stdout.
 * The runtime needs PYTHONPATH (and PT_INFER_DEVICE=cpu to run on the
 * CPU) in the environment (see paddle_tpu_torch/native/capi/
 * infer_capi.h).
 */
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

typedef void* (*create_fn)(const char*);
typedef int64_t (*run_fn)(void*, const float*, const int64_t*, int32_t,
                          float*, int64_t, int64_t*, int32_t*);
typedef void (*destroy_fn)(void*);
typedef const char* (*err_fn)(void);

int main(int argc, char** argv) {
  if (argc < 5) {
    fprintf(stderr, "usage: %s <lib.so> <artifact> <input.bin> <d0> [d1...]\n",
            argv[0]);
    return 2;
  }
  void* lib = dlopen(argv[1], RTLD_NOW | RTLD_GLOBAL);
  if (!lib) {
    fprintf(stderr, "dlopen: %s\n", dlerror());
    return 2;
  }
  create_fn create = (create_fn)dlsym(lib, "PT_InferCreate");
  run_fn run = (run_fn)dlsym(lib, "PT_InferRun");
  destroy_fn destroy = (destroy_fn)dlsym(lib, "PT_InferDestroy");
  err_fn last_err = (err_fn)dlsym(lib, "PT_InferLastError");
  if (!create || !run || !destroy || !last_err) {
    fprintf(stderr, "missing symbols in %s\n", argv[1]);
    return 2;
  }

  int32_t rank = argc - 4;
  if (rank > 8) {
    fprintf(stderr, "at most 8 input dims supported\n");
    return 2;
  }
  int64_t shape[8];
  int64_t n = 1;
  for (int i = 0; i < rank; ++i) {
    shape[i] = atoll(argv[4 + i]);
    n *= shape[i];
  }
  float* input = (float*)malloc(n * sizeof(float));
  FILE* f = fopen(argv[3], "rb");
  if (!f || fread(input, sizeof(float), (size_t)n, f) != (size_t)n) {
    fprintf(stderr, "failed reading %lld floats from %s\n", (long long)n,
            argv[3]);
    return 2;
  }
  fclose(f);

  void* pred = create(argv[2]);
  if (!pred) {
    fprintf(stderr, "PT_InferCreate: %s\n", last_err());
    return 1;
  }

  int64_t cap = 1 << 20;
  float* output = (float*)malloc(cap * sizeof(float));
  int64_t out_shape[8];
  int32_t out_rank = 0;
  int64_t wrote = run(pred, input, shape, rank, output, cap, out_shape,
                      &out_rank);
  if (wrote < 0) {
    fprintf(stderr, "PT_InferRun: %lld (%s)\n", (long long)wrote, last_err());
    return 1;
  }
  printf("shape");
  for (int i = 0; i < out_rank; ++i) printf(" %lld", (long long)out_shape[i]);
  printf("\n");
  for (int64_t i = 0; i < wrote; ++i) printf("%.8g\n", (double)output[i]);

  destroy(pred);
  free(input);
  free(output);
  return 0;
}
