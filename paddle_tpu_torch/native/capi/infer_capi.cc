// C inference API implementation — see infer_capi.h for the design note.
//
// Built SEPARATELY from the native runtime (this one links libpython):
// paddle_tpu_torch.inference.build_capi() compiles it on demand into
// build/native/libpaddle_tpu_torch_infer-<digest>.so.
//
// CPython embedding is deliberately string-free where it matters: inputs
// enter as zero-copy memoryviews, outputs leave through the buffer
// protocol — no serialization on the hot path.

#include "infer_capi.h"

#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <string>

namespace {

thread_local std::string g_last_error;

void SetError(const char* where) {
  g_last_error = where;
  if (PyErr_Occurred()) {
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    if (value) {
      PyObject* s = PyObject_Str(value);
      if (s) {
        const char* msg = PyUnicode_AsUTF8(s);
        if (msg) {
          g_last_error += ": ";
          g_last_error += msg;
        }
        Py_DECREF(s);
      }
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
  }
}

struct Predictor {
  PyObject* predictor = nullptr;  // paddle_tpu_torch.inference.Predictor
  PyObject* np = nullptr;         // numpy module
  int32_t n_inputs = 0;
  int32_t n_outputs = 0;
};

bool EnsurePython() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    if (!Py_IsInitialized()) {
      g_last_error = "CPython runtime failed to initialize";
      return false;
    }
    // release the GIL the init thread holds: every entry point takes it
    // back via PyGILState_Ensure, so calls from OTHER threads must not
    // find it permanently held by whoever happened to initialize
    PyEval_SaveThread();
  }
  return true;
}

class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

}  // namespace

extern "C" {

void* PT_InferCreate(const char* artifact_prefix) {
  if (!EnsurePython()) return nullptr;
  Gil gil;
  PyObject* mod = PyImport_ImportModule("paddle_tpu_torch.inference");
  if (!mod) {
    SetError("import paddle_tpu_torch.inference failed (is PYTHONPATH set?)");
    return nullptr;
  }
  PyObject* np = PyImport_ImportModule("numpy");
  if (!np) {
    Py_DECREF(mod);
    SetError("import numpy failed");
    return nullptr;
  }
  PyObject* cfg_cls = PyObject_GetAttrString(mod, "Config");
  PyObject* cfg = cfg_cls ? PyObject_CallFunction(
                                cfg_cls, "s", artifact_prefix)
                          : nullptr;
  // PT_INFER_DEVICE=cpu selects the CPU (the card otherwise)
  const char* device = std::getenv("PT_INFER_DEVICE");
  if (cfg && device && std::strcmp(device, "cpu") == 0) {
    PyObject* r = PyObject_CallMethod(cfg, "disable_gpu", nullptr);
    if (!r) {
      Py_DECREF(cfg);
      cfg = nullptr;
    }
    Py_XDECREF(r);
  }
  PyObject* create = PyObject_GetAttrString(mod, "create_predictor");
  PyObject* pred = (cfg && create)
                       ? PyObject_CallFunctionObjArgs(create, cfg, nullptr)
                       : nullptr;
  Py_XDECREF(cfg_cls);
  Py_XDECREF(cfg);
  Py_XDECREF(create);
  Py_DECREF(mod);
  if (!pred) {
    Py_DECREF(np);
    SetError("create_predictor failed");
    return nullptr;
  }
  auto* p = new Predictor();
  p->predictor = pred;
  p->np = np;
  PyObject* names = PyObject_CallMethod(pred, "get_input_names", nullptr);
  if (names) {
    p->n_inputs = static_cast<int32_t>(PySequence_Size(names));
    Py_DECREF(names);
  }
  names = PyObject_CallMethod(pred, "get_output_names", nullptr);
  if (names) {
    p->n_outputs = static_cast<int32_t>(PySequence_Size(names));
    Py_DECREF(names);
  }
  return p;
}

int32_t PT_InferNumInputs(void* h) {
  return h ? static_cast<Predictor*>(h)->n_inputs : -1;
}
int32_t PT_InferNumOutputs(void* h) {
  return h ? static_cast<Predictor*>(h)->n_outputs : -1;
}

int64_t PT_InferRun(void* h, const float* input, const int64_t* shape,
                    int32_t rank, float* output, int64_t output_capacity,
                    int64_t* out_shape, int32_t* out_rank) {
  if (!h) return -1;
  auto* p = static_cast<Predictor*>(h);
  Gil gil;
  int64_t n_elems = 1;
  for (int32_t i = 0; i < rank; ++i) n_elems *= shape[i];

  // zero-copy view over the caller's buffer -> np.frombuffer().reshape()
  PyObject* mem = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<float*>(input)),
      n_elems * static_cast<int64_t>(sizeof(float)), PyBUF_READ);
  PyObject* flat = mem ? PyObject_CallMethod(p->np, "frombuffer", "Os", mem,
                                             "float32")
                       : nullptr;
  PyObject* shp = PyTuple_New(rank);
  for (int32_t i = 0; i < rank; ++i) {
    PyTuple_SET_ITEM(shp, i, PyLong_FromLongLong(shape[i]));
  }
  PyObject* arr = flat ? PyObject_CallMethod(flat, "reshape", "O", shp)
                       : nullptr;
  Py_XDECREF(mem);
  Py_XDECREF(flat);
  Py_XDECREF(shp);
  if (!arr) {
    SetError("building input array failed");
    return -2;
  }
  PyObject* inputs = PyList_New(1);
  PyList_SET_ITEM(inputs, 0, arr);  // steals arr
  PyObject* outs = PyObject_CallMethod(p->predictor, "run", "O", inputs);
  Py_DECREF(inputs);
  if (!outs) {
    SetError("predictor.run failed");
    return -3;
  }
  PyObject* out0 = PySequence_GetItem(outs, 0);
  Py_DECREF(outs);
  if (!out0) {
    SetError("no outputs");
    return -4;
  }
  // force float32 C-contiguous, then read through the buffer protocol
  PyObject* cont = PyObject_CallMethod(p->np, "ascontiguousarray", "Os", out0,
                                       "float32");
  Py_DECREF(out0);
  if (!cont) {
    SetError("output conversion failed");
    return -5;
  }
  Py_buffer view;
  if (PyObject_GetBuffer(cont, &view, PyBUF_ND | PyBUF_FORMAT) != 0) {
    Py_DECREF(cont);
    SetError("output buffer protocol failed");
    return -6;
  }
  int64_t total = view.len / static_cast<int64_t>(sizeof(float));
  if (total > output_capacity) {
    PyBuffer_Release(&view);
    Py_DECREF(cont);
    g_last_error = "output buffer too small";
    return -7;
  }
  if (view.ndim > 8) {  // header contract: out_shape holds 8 entries
    PyBuffer_Release(&view);
    Py_DECREF(cont);
    g_last_error = "output rank > 8 unsupported";
    return -8;
  }
  std::memcpy(output, view.buf, view.len);
  *out_rank = static_cast<int32_t>(view.ndim);
  for (int i = 0; i < view.ndim; ++i) out_shape[i] = view.shape[i];
  PyBuffer_Release(&view);
  Py_DECREF(cont);
  return total;
}

void PT_InferDestroy(void* h) {
  if (!h) return;
  auto* p = static_cast<Predictor*>(h);
  if (Py_IsInitialized()) {
    Gil gil;
    Py_XDECREF(p->predictor);
    Py_XDECREF(p->np);
  }
  delete p;
}

const char* PT_InferLastError(void) { return g_last_error.c_str(); }
}
