// Model-level C ABI — native counterpart of the reference's
// src/visp/c-api.cpp:1-253 (visp_model_load / visp_model_compute /
// visp_model_destroy with opaque handles, thread-local error strings,
// int32 status codes).
//
// The reference's C API fronts a C++ engine; this engine is the
// vision_tpu_torch Python package running on PyTorch and the hand-written
// Hopper kernels, so the shim embeds CPython and forwards to
// vision_tpu_torch/capi.py, which does all marshalling with primitive
// types. Built with g++ at first use by vision_tpu_torch/native/__init__.py
// (capi_library_path: build/vision_tpu_torch/libvtt_capi-<hash>.so).
// Consumers dlopen the library, call visp_init("<repo-or-site-dir>") once,
// then use the visp_* calls from any thread (the GIL is acquired per call;
// per-model handles serialize their own stateful paths in capi.py).

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>

#define VISP_API __attribute__((visibility("default")))

namespace {

thread_local std::string g_error;

void set_error(const char* msg) {
    g_error = msg ? msg : "unknown error";
}

void set_error_from_python() {
    PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
    PyErr_Fetch(&type, &value, &trace);
    PyErr_NormalizeException(&type, &value, &trace);
    if (value) {
        PyObject* s = PyObject_Str(value);
        if (s) {
            set_error(PyUnicode_AsUTF8(s));
            Py_DECREF(s);
        } else {
            set_error("python exception (unprintable)");
        }
    } else {
        set_error("python exception");
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(trace);
}

PyObject* g_capi = nullptr;  // vision_tpu_torch.capi module

// PyGILState_Ensure on an UNINITIALIZED runtime aborts the process, so every
// entry point must check this BEFORE constructing a GIL guard.
bool require_init() {
    if (!Py_IsInitialized() || !g_capi) {
        set_error("visp_init was not called");
        return false;
    }
    return true;
}

struct GIL {
    PyGILState_STATE state;
    GIL() : state(PyGILState_Ensure()) {}
    ~GIL() { PyGILState_Release(state); }
};

PyObject* call(const char* fn, PyObject* args) {
    // takes ownership of args; returns new ref or nullptr with error set
    if (!g_capi) {
        Py_XDECREF(args);
        set_error("visp_init was not called");
        return nullptr;
    }
    if (!args) {
        // a failed Py_BuildValue left an exception pending; calling into
        // Python with NULL args would be undefined behavior
        set_error_from_python();
        return nullptr;
    }
    PyObject* f = PyObject_GetAttrString(g_capi, fn);
    if (!f) {
        Py_XDECREF(args);
        set_error_from_python();
        return nullptr;
    }
    PyObject* r = PyObject_CallObject(f, args);
    Py_DECREF(f);
    Py_XDECREF(args);
    if (!r) set_error_from_python();
    return r;
}

}  // namespace

extern "C" {

struct visp_image_view {
    int32_t width;
    int32_t height;
    int32_t stride;  // bytes per row
    int32_t format;  // index into capi.FORMATS (reference image.h order)
    void* data;
};

// opaque handle types
typedef struct visp_device visp_device;   // PyObject* (Device)
typedef struct visp_model visp_model;     // PyObject* ((model, family, lock) tuple)
typedef struct visp_image visp_image;     // PyObject* (u8 numpy buffer)

VISP_API const char* visp_get_last_error() {
    return g_error.c_str();
}

// Initialize the embedded interpreter and import vision_tpu_torch from `dir`
// (the analog of the reference's visp_backend_load_all, c-api.cpp:160-163:
// there it loads backend DLLs from a directory; here the "backend" is the
// vision_tpu_torch package and PyTorch). Returns 1 on success.
VISP_API int32_t visp_init(const char* dir) {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        // Drop the GIL acquired by Py_Initialize so per-call GIL guards work.
        PyEval_SaveThread();
    }
    GIL gil;
    if (g_capi) return 1;
    if (dir && *dir) {
        PyObject* sys_path = PySys_GetObject("path");  // borrowed
        PyObject* p = PyUnicode_FromString(dir);
        if (sys_path && p) PyList_Insert(sys_path, 0, p);
        Py_XDECREF(p);
    }
    g_capi = PyImport_ImportModule("vision_tpu_torch.capi");
    if (!g_capi) {
        set_error_from_python();
        return 0;
    }
    return 1;
}

// device

VISP_API int32_t visp_device_init(int32_t type, visp_device** out_device) {
    if (!require_init() || !out_device) {
        if (!out_device) set_error("out_device is NULL");
        return 0;
    }
    GIL gil;
    PyObject* r = call("device_init", Py_BuildValue("(i)", type));
    if (!r) return 0;
    *out_device = reinterpret_cast<visp_device*>(r);
    return 1;
}

VISP_API void visp_device_destroy(visp_device* d) {
    if (!d || !Py_IsInitialized()) return;
    GIL gil;
    Py_DECREF(reinterpret_cast<PyObject*>(d));
}

VISP_API int32_t visp_device_type(const visp_device* d) {
    if (!require_init()) return -1;
    if (!d) {
        set_error("device handle is NULL");
        return -1;
    }
    GIL gil;
    PyObject* r = call("device_type", Py_BuildValue("(O)", reinterpret_cast<PyObject*>(const_cast<visp_device*>(d))));
    if (!r) return -1;
    long v = PyLong_AsLong(r);
    Py_DECREF(r);
    return (int32_t)v;
}

// models

VISP_API int32_t visp_model_detect_family(const char* filepath, int32_t* out_family) {
    if (!require_init() || !filepath || !out_family) {
        if (Py_IsInitialized() && g_capi) set_error("filepath/out_family is NULL");
        return 0;
    }
    GIL gil;
    PyObject* r = call("model_detect_family", Py_BuildValue("(s)", filepath));
    if (!r) return 0;
    *out_family = (int32_t)PyLong_AsLong(r);
    Py_DECREF(r);
    return 1;
}

VISP_API int32_t visp_model_load(
    const char* filepath, const visp_device* dev, int32_t family, visp_model** out) {
    if (!require_init() || !filepath || !dev || !out) {
        if (Py_IsInitialized() && g_capi) set_error("filepath/device/out is NULL");
        return 0;
    }
    GIL gil;
    PyObject* r = call(
        "model_load",
        Py_BuildValue("(sOi)", filepath, reinterpret_cast<PyObject*>(const_cast<visp_device*>(dev)), family));
    if (!r) return 0;
    *out = reinterpret_cast<visp_model*>(r);
    return 1;
}

VISP_API void visp_model_destroy(visp_model* model, int32_t /*family*/) {
    if (!model || !Py_IsInitialized()) return;
    GIL gil;
    Py_DECREF(reinterpret_cast<PyObject*>(model));
}

VISP_API void visp_image_destroy(visp_image* img) {
    if (!img || !Py_IsInitialized()) return;
    GIL gil;
    Py_DECREF(reinterpret_cast<PyObject*>(img));
}

// Run a model: `inputs` images are copied into the interpreter; the output
// image's pixels live in *out_data (visp_image handle) until
// visp_image_destroy (reference visp_model_compute, c-api.cpp:216-239).
VISP_API int32_t visp_model_compute(
    visp_model* model,
    int32_t /*family: carried inside the handle*/,
    const visp_image_view* inputs,
    int32_t n_inputs,
    const int32_t* args,
    int32_t n_args,
    visp_image_view* out_image,
    visp_image** out_data) {
    if (!require_init()) return 0;
    if (!model || !out_image || !out_data || (n_inputs > 0 && !inputs)) {
        set_error("model/inputs/out pointers must be non-NULL");
        return 0;
    }
    // bytes/pixel per format index (capi.FORMATS order: rgba/bgra/argb/rgb/
    // alpha u8, then rgba/rgb/alpha f32)
    static const int32_t kBytesPerPixel[8] = {4, 4, 4, 3, 1, 16, 12, 4};
    // validate views on the native side: a garbage extent would otherwise
    // overread the caller's buffer or crash the interpreter below
    for (int32_t i = 0; i < n_inputs; ++i) {
        const visp_image_view& v = inputs[i];
        if (v.width <= 0 || v.height <= 0 || v.stride <= 0 || !v.data) {
            set_error("input image view has non-positive extent/stride or NULL data");
            return 0;
        }
        if (v.format < 0 || v.format >= 8) {
            set_error("input image view has an invalid format code");
            return 0;
        }
        if ((int64_t)v.width * kBytesPerPixel[v.format] > v.stride) {
            set_error("input image view stride is smaller than a pixel row");
            return 0;
        }
    }

    GIL gil;

    PyObject* images = PyList_New(n_inputs);
    if (!images) {
        set_error_from_python();
        return 0;
    }
    for (int32_t i = 0; i < n_inputs; ++i) {
        const visp_image_view& v = inputs[i];
        // full stride for all but the LAST row, then only its pixel bytes:
        // copying stride*height would overread a tightly allocated buffer
        // whose final row is unpadded (a common sub-rect layout)
        Py_ssize_t row_bytes = (Py_ssize_t)v.width * kBytesPerPixel[v.format];
        Py_ssize_t total = (Py_ssize_t)v.stride * (v.height - 1) + row_bytes;
        PyObject* bytes = PyBytes_FromStringAndSize(
            reinterpret_cast<const char*>(v.data), total);
        PyObject* tup = bytes
            ? Py_BuildValue("(iiiiN)", v.width, v.height, v.stride, v.format, bytes)
            : nullptr;
        if (!tup) {
            Py_XDECREF(bytes);
            Py_DECREF(images);
            set_error_from_python();
            return 0;
        }
        PyList_SET_ITEM(images, i, tup);
    }
    PyObject* py_args = PyList_New(n_args);
    if (!py_args) {
        Py_DECREF(images);
        set_error_from_python();
        return 0;
    }
    for (int32_t i = 0; i < n_args; ++i) {
        PyObject* v = PyLong_FromLong(args ? args[i] : 0);
        if (!v) {
            Py_DECREF(images);
            Py_DECREF(py_args);
            set_error_from_python();
            return 0;
        }
        PyList_SET_ITEM(py_args, i, v);
    }

    PyObject* r = call(
        "model_compute",
        Py_BuildValue("(ONN)", reinterpret_cast<PyObject*>(model), images, py_args));
    if (!r) return 0;

    // r = (u8_buffer, width, height, stride, fmt)
    if (!PyTuple_Check(r) || PyTuple_GET_SIZE(r) != 5) {
        set_error("capi.model_compute returned an unexpected result shape");
        Py_DECREF(r);
        return 0;
    }
    PyObject* buf = PyTuple_GET_ITEM(r, 0);  // borrowed
    visp_image_view out;
    out.width = (int32_t)PyLong_AsLong(PyTuple_GET_ITEM(r, 1));
    out.height = (int32_t)PyLong_AsLong(PyTuple_GET_ITEM(r, 2));
    out.stride = (int32_t)PyLong_AsLong(PyTuple_GET_ITEM(r, 3));
    out.format = (int32_t)PyLong_AsLong(PyTuple_GET_ITEM(r, 4));
    if (PyErr_Occurred()) {
        set_error_from_python();
        Py_DECREF(r);
        return 0;
    }

    Py_buffer view;
    if (PyObject_GetBuffer(buf, &view, PyBUF_SIMPLE) != 0) {
        set_error_from_python();
        Py_DECREF(r);
        return 0;
    }
    out.data = view.buf;
    PyBuffer_Release(&view);  // numpy keeps the memory alive while r lives
    *out_image = out;  // written only on success
    *out_data = reinterpret_cast<visp_image*>(r);
    return 1;
}

}  // extern "C"
