/* amgx_tpu_torch_c.c — native C implementation of the AMGX-compatible
 * API over the PyTorch port.
 *
 * Strategy: embed the CPython runtime and dispatch into
 * amgx_tpu_torch.api.capi (the handle layer).  Arrays cross the boundary as
 * PyBytes copies sized by the mode's dtypes (itemsizes queried from the
 * Python mode table at create time — single source of truth); results
 * come back through the buffer protocol.  Exceptions carry an .rc
 * attribute converted to the AMGX_RC return code (the reference does the
 * same with AMGX_TRIES/AMGX_CATCHES, amgx_c.cu).
 *
 * Threading: every entry point takes the GIL via PyGILState_Ensure, so
 * host apps may call from any thread (AMGX permits this).  When this
 * library initializes Python itself, the main thread then releases its
 * thread state; loaded into a running interpreter (ctypes.PyDLL) it
 * leaves the caller's GIL as it found it.
 *
 * Built at first use by amgx_tpu_torch/ops/kernels.py:build_native (cc
 * with python3-config --cflags/--ldflags --embed) into
 * amgx_tpu_torch/_build/.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>
#include <stdio.h>
#include <stdlib.h>
#include <dlfcn.h>
#include <libgen.h>

#include "amgx_tpu_torch_c.h"

static PyObject *g_capi = NULL; /* amgx_tpu_torch.api.capi module */
static PyThreadState *g_saved_ts = NULL;

/* per-handle dtype bookkeeping so upload/download can size buffers */
#define MAX_TRACKED 65536
static struct {
  uintptr_t handle;
  size_t mat_size;
  size_t vec_size;
  int block_size;
} g_modes[MAX_TRACKED];
static int g_mode_count = 0;

static int track_handle(uintptr_t h, size_t mat_size, size_t vec_size) {
  if (g_mode_count >= MAX_TRACKED) return 0;
  g_modes[g_mode_count].handle = h;
  g_modes[g_mode_count].mat_size = mat_size;
  g_modes[g_mode_count].vec_size = vec_size;
  g_modes[g_mode_count].block_size = 1;
  g_mode_count++;
  return 1;
}

static int handle_entry(uintptr_t h) {
  for (int i = 0; i < g_mode_count; ++i)
    if (g_modes[i].handle == h) return i;
  return -1;
}

static void untrack_handle(uintptr_t h) {
  int i = handle_entry(h);
  if (i >= 0) {
    g_modes[i] = g_modes[g_mode_count - 1];
    g_mode_count--;
  }
}

/* Convert a pending Python exception to an AMGX_RC (GIL held). */
static AMGX_RC rc_from_exception(void) {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  AMGX_RC rc = AMGX_RC_UNKNOWN;
  if (value) {
    PyObject *rc_attr = PyObject_GetAttrString(value, "rc");
    if (rc_attr) {
      long v = PyLong_AsLong(rc_attr);
      if (v >= 0 && v <= AMGX_RC_INTERNAL) rc = (AMGX_RC)v;
      Py_DECREF(rc_attr);
    } else {
      PyErr_Clear();
      PyObject *s = PyObject_Str(value);
      if (s) {
        fprintf(stderr, "amgx_tpu_torch_c: %s\n", PyUnicode_AsUTF8(s));
        Py_DECREF(s);
      }
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return rc;
}

/* Call capi.<fn>(args...) (GIL held).  Consumes args (which may be NULL
 * from a failed Py_BuildValue — detected and propagated). */
static PyObject *capi_call(const char *fn, PyObject *args, int had_args) {
  if (had_args && !args) return NULL; /* Py_BuildValue failed */
  if (!g_capi) {
    Py_XDECREF(args);
    PyErr_SetString(PyExc_RuntimeError, "AMGX_initialize not called");
    return NULL;
  }
  PyObject *f = PyObject_GetAttrString(g_capi, fn);
  if (!f) {
    Py_XDECREF(args);
    return NULL;
  }
  PyObject *r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  return r;
}

/* GIL-wrapped call returning only an RC. */
static AMGX_RC call_rc(const char *fn, PyObject *args, int had_args) {
  PyObject *r = capi_call(fn, args, had_args);
  AMGX_RC rc = AMGX_RC_OK;
  if (!r)
    rc = rc_from_exception();
  else
    Py_DECREF(r);
  return rc;
}

#define ENTER() PyGILState_STATE gst_ = PyGILState_Ensure()
/* evaluate the return expression BEFORE releasing the GIL — arguments
 * routinely call PyErr_Occurred()/rc_from_exception() */
#define LEAVE_RET(rc)           \
  do {                          \
    AMGX_RC rc_eval_ = (rc);    \
    PyGILState_Release(gst_);   \
    return rc_eval_;            \
  } while (0)

/* ------------------------------------------------------------------ */

/* The library is built into <repo>/amgx_tpu_torch/_build/, two
 * directories below the repository root that holds the amgx_tpu_torch
 * package.  Host apps can run from anywhere, so locate the .so via
 * dladdr and append that root to sys.path before the first import (GIL
 * held). */
static void add_package_to_syspath(void) {
  Dl_info info;
  char buf[4096];
  PyObject *sys_path = PySys_GetObject("path"); /* borrowed */
  if (!sys_path) return;
  if (dladdr((void *)&add_package_to_syspath, &info) && info.dli_fname) {
    strncpy(buf, info.dli_fname, sizeof(buf) - 1);
    buf[sizeof(buf) - 1] = '\0';
    char *dir = dirname(buf);    /* <repo>/amgx_tpu_torch/_build */
    char *pkg = dirname(dir);    /* <repo>/amgx_tpu_torch */
    char *repo = dirname(pkg);   /* <repo> */
    PyObject *p = PyUnicode_FromString(repo);
    if (p) {
      PyList_Append(sys_path, p);
      Py_DECREF(p);
    }
  }
}

AMGX_RC AMGX_initialize(void) {
  if (!Py_IsInitialized()) {
    Py_Initialize();
    add_package_to_syspath();
    PyObject *mod = PyImport_ImportModule("amgx_tpu_torch.api.capi");
    if (!mod) {
      PyErr_Print();
      return AMGX_RC_CORE;
    }
    g_capi = mod;
    AMGX_RC rc = call_rc("initialize", NULL, 0);
    /* release the main thread state so other host threads can enter via
     * PyGILState_Ensure */
    g_saved_ts = PyEval_SaveThread();
    return rc;
  }
  ENTER();
  if (!g_capi) {
    add_package_to_syspath(); /* host may have pre-initialized Python */
    PyObject *mod = PyImport_ImportModule("amgx_tpu_torch.api.capi");
    if (!mod) LEAVE_RET(AMGX_RC_CORE);
    g_capi = mod;
  }
  AMGX_RC rc = call_rc("initialize", NULL, 0);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_finalize(void) {
  ENTER();
  AMGX_RC rc = AMGX_RC_OK;
  if (g_capi) {
    rc = call_rc("finalize", NULL, 0);
    Py_CLEAR(g_capi);
  }
  g_mode_count = 0;
  LEAVE_RET(rc);
}

AMGX_RC AMGX_get_api_version(int *major, int *minor) {
  ENTER();
  PyObject *r = capi_call("get_api_version", NULL, 0);
  if (!r) LEAVE_RET(rc_from_exception());
  int ok = PyArg_ParseTuple(r, "ii", major, minor);
  Py_DECREF(r);
  LEAVE_RET(ok ? AMGX_RC_OK : rc_from_exception());
}

/* The host's print callback receives every line the library prints
 * (reference AMGX_register_print_callback, amgx_c.h:189-191). */
static AMGX_print_callback g_print_cb = NULL;

static PyObject *print_trampoline(PyObject *self, PyObject *text) {
  (void)self;
  Py_ssize_t len = 0;
  const char *msg = PyUnicode_AsUTF8AndSize(text, &len);
  if (!msg) return NULL;
  if (g_print_cb) g_print_cb(msg, (int)len);
  Py_RETURN_NONE;
}

static PyMethodDef g_print_def = {"amgx_print_callback", print_trampoline,
                                  METH_O, NULL};

AMGX_RC AMGX_register_print_callback(AMGX_print_callback func) {
  ENTER();
  g_print_cb = func;
  PyObject *fn = func ? PyCFunction_New(&g_print_def, NULL)
                      : (Py_INCREF(Py_None), Py_None);
  if (!fn) LEAVE_RET(rc_from_exception());
  AMGX_RC rc = call_rc("register_print_callback", Py_BuildValue("(N)", fn),
                       1);
  LEAVE_RET(rc);
}

const char *AMGX_get_error_string(AMGX_RC rc) {
  switch (rc) {
    case AMGX_RC_OK: return "success";
    case AMGX_RC_BAD_PARAMETERS: return "bad parameters";
    case AMGX_RC_IO_ERROR: return "I/O error";
    case AMGX_RC_BAD_MODE: return "bad mode";
    case AMGX_RC_BAD_CONFIGURATION: return "bad configuration";
    case AMGX_RC_NOT_IMPLEMENTED: return "not implemented";
    default: return "error";
  }
}

AMGX_RC AMGX_config_create(AMGX_config_handle *cfg, const char *options) {
  ENTER();
  PyObject *r =
      capi_call("config_create", Py_BuildValue("(s)", options), 1);
  if (!r) LEAVE_RET(rc_from_exception());
  *cfg = (uintptr_t)PyLong_AsUnsignedLongLong(r);
  Py_DECREF(r);
  LEAVE_RET(PyErr_Occurred() ? rc_from_exception() : AMGX_RC_OK);
}

AMGX_RC AMGX_config_create_from_file(AMGX_config_handle *cfg,
                                     const char *path) {
  ENTER();
  PyObject *r =
      capi_call("config_create_from_file", Py_BuildValue("(s)", path), 1);
  if (!r) LEAVE_RET(rc_from_exception());
  *cfg = (uintptr_t)PyLong_AsUnsignedLongLong(r);
  Py_DECREF(r);
  LEAVE_RET(PyErr_Occurred() ? rc_from_exception() : AMGX_RC_OK);
}

AMGX_RC AMGX_config_add_parameters(AMGX_config_handle cfg,
                                   const char *options) {
  ENTER();
  AMGX_RC rc = call_rc(
      "config_add_parameters",
      Py_BuildValue("(Ks)", (unsigned long long)cfg, options), 1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_config_destroy(AMGX_config_handle cfg) {
  ENTER();
  AMGX_RC rc = call_rc("config_destroy",
                       Py_BuildValue("(K)", (unsigned long long)cfg), 1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_resources_create_simple(AMGX_resources_handle *res,
                                     AMGX_config_handle cfg) {
  ENTER();
  PyObject *r = capi_call("resources_create_simple",
                          Py_BuildValue("(K)", (unsigned long long)cfg), 1);
  if (!r) LEAVE_RET(rc_from_exception());
  *res = (uintptr_t)PyLong_AsUnsignedLongLong(r);
  Py_DECREF(r);
  LEAVE_RET(PyErr_Occurred() ? rc_from_exception() : AMGX_RC_OK);
}

AMGX_RC AMGX_resources_destroy(AMGX_resources_handle res) {
  ENTER();
  AMGX_RC rc = call_rc("resources_destroy",
                       Py_BuildValue("(K)", (unsigned long long)res), 1);
  LEAVE_RET(rc);
}

/* Create a mode-carrying object and record its dtype itemsizes (queried
 * from Python — single source of truth). */
static AMGX_RC create_with_mode(const char *pyfn, uintptr_t first_arg,
                                const char *mode, uintptr_t extra_cfg,
                                int has_cfg, uintptr_t *out) {
  PyObject *args =
      has_cfg ? Py_BuildValue("(KsK)", (unsigned long long)first_arg, mode,
                              (unsigned long long)extra_cfg)
              : Py_BuildValue("(Ks)", (unsigned long long)first_arg, mode);
  PyObject *r = capi_call(pyfn, args, 1);
  if (!r) return rc_from_exception();
  *out = (uintptr_t)PyLong_AsUnsignedLongLong(r);
  Py_DECREF(r);
  if (PyErr_Occurred()) return rc_from_exception();
  PyObject *sz =
      capi_call("mode_itemsizes", Py_BuildValue("(s)", mode), 1);
  if (!sz) return rc_from_exception();
  int mat_s, vec_s;
  int ok = PyArg_ParseTuple(sz, "ii", &mat_s, &vec_s);
  Py_DECREF(sz);
  if (!ok) return rc_from_exception();
  if (!track_handle(*out, (size_t)mat_s, (size_t)vec_s))
    return AMGX_RC_INTERNAL;
  return AMGX_RC_OK;
}

AMGX_RC AMGX_matrix_create(AMGX_matrix_handle *mtx,
                           AMGX_resources_handle res, const char *mode) {
  ENTER();
  AMGX_RC rc = create_with_mode("matrix_create", res, mode, 0, 0, mtx);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_matrix_upload_all(AMGX_matrix_handle mtx, int n, int nnz,
                               int block_dimx, int block_dimy,
                               const int *row_ptrs, const int *col_indices,
                               const void *data, const void *diag_data) {
  ENTER();
  int e = handle_entry(mtx);
  if (e < 0) LEAVE_RET(AMGX_RC_BAD_PARAMETERS);
  size_t msz = g_modes[e].mat_size;
  size_t vsz = msz * (size_t)nnz * block_dimx * block_dimy;
  size_t dsz = msz * (size_t)n * block_dimx * block_dimy;
  PyObject *diag = diag_data
                       ? PyBytes_FromStringAndSize((const char *)diag_data,
                                                   (Py_ssize_t)dsz)
                       : (Py_INCREF(Py_None), Py_None);
  AMGX_RC rc = call_rc(
      "matrix_upload_all",
      Py_BuildValue(
          "(Kiiiiy#y#y#N)", (unsigned long long)mtx, n, nnz, block_dimx,
          block_dimy, (const char *)row_ptrs,
          (Py_ssize_t)(sizeof(int) * (size_t)(n + 1)),
          (const char *)col_indices,
          (Py_ssize_t)(sizeof(int) * (size_t)nnz), (const char *)data,
          (Py_ssize_t)vsz, diag),
      1);
  if (rc == AMGX_RC_OK) g_modes[handle_entry(mtx)].block_size = block_dimx;
  LEAVE_RET(rc);
}

AMGX_RC AMGX_matrix_replace_coefficients(AMGX_matrix_handle mtx, int n,
                                         int nnz, const void *data,
                                         const void *diag_data) {
  ENTER();
  int e = handle_entry(mtx);
  if (e < 0) LEAVE_RET(AMGX_RC_BAD_PARAMETERS);
  if (diag_data) LEAVE_RET(AMGX_RC_NOT_IMPLEMENTED);
  int bs = g_modes[e].block_size;
  size_t vsz = g_modes[e].mat_size * (size_t)nnz * bs * bs;
  AMGX_RC rc = call_rc(
      "matrix_replace_coefficients",
      Py_BuildValue("(Kiiy#)", (unsigned long long)mtx, n, nnz,
                    (const char *)data, (Py_ssize_t)vsz),
      1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_matrix_get_size(AMGX_matrix_handle mtx, int *n,
                             int *block_dimx, int *block_dimy) {
  ENTER();
  PyObject *r = capi_call("matrix_get_size",
                          Py_BuildValue("(K)", (unsigned long long)mtx), 1);
  if (!r) LEAVE_RET(rc_from_exception());
  int ok = PyArg_ParseTuple(r, "iii", n, block_dimx, block_dimy);
  Py_DECREF(r);
  LEAVE_RET(ok ? AMGX_RC_OK : rc_from_exception());
}

AMGX_RC AMGX_matrix_destroy(AMGX_matrix_handle mtx) {
  ENTER();
  AMGX_RC rc = call_rc("matrix_destroy",
                       Py_BuildValue("(K)", (unsigned long long)mtx), 1);
  untrack_handle(mtx);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_vector_create(AMGX_vector_handle *vec,
                           AMGX_resources_handle res, const char *mode) {
  ENTER();
  AMGX_RC rc = create_with_mode("vector_create", res, mode, 0, 0, vec);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_vector_upload(AMGX_vector_handle vec, int n, int block_dim,
                           const void *data) {
  ENTER();
  int e = handle_entry(vec);
  if (e < 0) LEAVE_RET(AMGX_RC_BAD_PARAMETERS);
  size_t sz = g_modes[e].vec_size * (size_t)n * block_dim;
  AMGX_RC rc = call_rc(
      "vector_upload",
      Py_BuildValue("(Kiiy#)", (unsigned long long)vec, n, block_dim,
                    (const char *)data, (Py_ssize_t)sz),
      1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_vector_download(AMGX_vector_handle vec, void *data) {
  ENTER();
  PyObject *r = capi_call("vector_download",
                          Py_BuildValue("(K)", (unsigned long long)vec), 1);
  if (!r) LEAVE_RET(rc_from_exception());
  Py_buffer view;
  if (PyObject_GetBuffer(r, &view, PyBUF_CONTIG_RO) != 0) {
    Py_DECREF(r);
    LEAVE_RET(rc_from_exception());
  }
  memcpy(data, view.buf, (size_t)view.len);
  PyBuffer_Release(&view);
  Py_DECREF(r);
  LEAVE_RET(AMGX_RC_OK);
}

AMGX_RC AMGX_vector_set_zero(AMGX_vector_handle vec, int n,
                             int block_dim) {
  ENTER();
  AMGX_RC rc = call_rc("vector_set_zero",
                       Py_BuildValue("(Kii)", (unsigned long long)vec, n,
                                     block_dim),
                       1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_vector_bind(AMGX_vector_handle vec, AMGX_matrix_handle mtx) {
  ENTER();
  AMGX_RC rc = call_rc("vector_bind",
                       Py_BuildValue("(KK)", (unsigned long long)vec,
                                     (unsigned long long)mtx),
                       1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_vector_get_size(AMGX_vector_handle vec, int *n,
                             int *block_dim) {
  ENTER();
  PyObject *r = capi_call("vector_get_size",
                          Py_BuildValue("(K)", (unsigned long long)vec), 1);
  if (!r) LEAVE_RET(rc_from_exception());
  int ok = PyArg_ParseTuple(r, "ii", n, block_dim);
  Py_DECREF(r);
  LEAVE_RET(ok ? AMGX_RC_OK : rc_from_exception());
}

AMGX_RC AMGX_vector_destroy(AMGX_vector_handle vec) {
  ENTER();
  AMGX_RC rc = call_rc("vector_destroy",
                       Py_BuildValue("(K)", (unsigned long long)vec), 1);
  untrack_handle(vec);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_solver_create(AMGX_solver_handle *slv,
                           AMGX_resources_handle res, const char *mode,
                           AMGX_config_handle cfg) {
  ENTER();
  AMGX_RC rc = create_with_mode("solver_create", res, mode, cfg, 1, slv);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_solver_setup(AMGX_solver_handle slv, AMGX_matrix_handle mtx) {
  ENTER();
  AMGX_RC rc = call_rc("solver_setup",
                       Py_BuildValue("(KK)", (unsigned long long)slv,
                                     (unsigned long long)mtx),
                       1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_solver_solve(AMGX_solver_handle slv, AMGX_vector_handle rhs,
                          AMGX_vector_handle sol) {
  ENTER();
  AMGX_RC rc = call_rc("solver_solve",
                       Py_BuildValue("(KKK)", (unsigned long long)slv,
                                     (unsigned long long)rhs,
                                     (unsigned long long)sol),
                       1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_solver_solve_with_0_initial_guess(AMGX_solver_handle slv,
                                               AMGX_vector_handle rhs,
                                               AMGX_vector_handle sol) {
  ENTER();
  AMGX_RC rc = call_rc("solver_solve_with_0_initial_guess",
                       Py_BuildValue("(KKK)", (unsigned long long)slv,
                                     (unsigned long long)rhs,
                                     (unsigned long long)sol),
                       1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_solver_get_status(AMGX_solver_handle slv,
                               AMGX_SOLVE_STATUS *status) {
  ENTER();
  PyObject *r = capi_call("solver_get_status",
                          Py_BuildValue("(K)", (unsigned long long)slv), 1);
  if (!r) LEAVE_RET(rc_from_exception());
  *status = (AMGX_SOLVE_STATUS)PyLong_AsLong(r);
  Py_DECREF(r);
  LEAVE_RET(AMGX_RC_OK);
}

AMGX_RC AMGX_solver_get_iterations_number(AMGX_solver_handle slv,
                                          int *n) {
  ENTER();
  PyObject *r =
      capi_call("solver_get_iterations_number",
                Py_BuildValue("(K)", (unsigned long long)slv), 1);
  if (!r) LEAVE_RET(rc_from_exception());
  *n = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  LEAVE_RET(AMGX_RC_OK);
}

AMGX_RC AMGX_solver_get_iteration_residual(AMGX_solver_handle slv, int it,
                                           int idx, double *res) {
  ENTER();
  PyObject *r = capi_call(
      "solver_get_iteration_residual",
      Py_BuildValue("(Kii)", (unsigned long long)slv, it, idx), 1);
  if (!r) LEAVE_RET(rc_from_exception());
  *res = PyFloat_AsDouble(r);
  Py_DECREF(r);
  LEAVE_RET(AMGX_RC_OK);
}

/* Batched solve of n systems through the serve layer
 * (amgx_tpu_torch.serve); per-system results through the handle
 * layer's batch accessors. */
AMGX_RC AMGX_solver_solve_batch(AMGX_solver_handle slv, int n,
                                const AMGX_matrix_handle *mtx,
                                const AMGX_vector_handle *rhs,
                                AMGX_vector_handle *sol) {
  ENTER();
  PyObject *m = PyList_New(n > 0 ? n : 0);
  PyObject *r = PyList_New(n > 0 ? n : 0);
  PyObject *x = PyList_New(n > 0 ? n : 0);
  if (!m || !r || !x) {
    Py_XDECREF(m);
    Py_XDECREF(r);
    Py_XDECREF(x);
    LEAVE_RET(rc_from_exception());
  }
  for (int i = 0; i < n; ++i) {
    PyList_SetItem(m, i, PyLong_FromUnsignedLongLong(mtx[i]));
    PyList_SetItem(r, i, PyLong_FromUnsignedLongLong(rhs[i]));
    PyList_SetItem(x, i, PyLong_FromUnsignedLongLong(sol[i]));
  }
  AMGX_RC rc = call_rc(
      "solver_solve_batch",
      Py_BuildValue("(KNNN)", (unsigned long long)slv, m, r, x), 1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_solver_destroy(AMGX_solver_handle slv) {
  ENTER();
  AMGX_RC rc = call_rc("solver_destroy",
                       Py_BuildValue("(K)", (unsigned long long)slv), 1);
  untrack_handle(slv);
  LEAVE_RET(rc);
}

/* setup persistence (no reference analogue: AMGX_write_system can only
 * persist the SYSTEM, so every process restart re-pays setup; these
 * persist the completed setup itself — see doc/PERSISTENCE.md) */

AMGX_RC AMGX_solver_save(AMGX_solver_handle slv, const char *filename) {
  ENTER();
  AMGX_RC rc = call_rc(
      "solver_save",
      Py_BuildValue("(Ks)", (unsigned long long)slv, filename), 1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_solver_load(AMGX_solver_handle slv, const char *filename) {
  ENTER();
  AMGX_RC rc = call_rc(
      "solver_load",
      Py_BuildValue("(Ks)", (unsigned long long)slv, filename), 1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_read_system(AMGX_matrix_handle mtx, AMGX_vector_handle rhs,
                         AMGX_vector_handle sol, const char *filename) {
  ENTER();
  AMGX_RC rc = call_rc("read_system",
                       Py_BuildValue("(KKKs)", (unsigned long long)mtx,
                                     (unsigned long long)rhs,
                                     (unsigned long long)sol, filename),
                       1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_write_system(AMGX_matrix_handle mtx, AMGX_vector_handle rhs,
                          AMGX_vector_handle sol, const char *filename) {
  ENTER();
  AMGX_RC rc = call_rc("write_system",
                       Py_BuildValue("(KKKs)", (unsigned long long)mtx,
                                     (unsigned long long)rhs,
                                     (unsigned long long)sol, filename),
                       1);
  LEAVE_RET(rc);
}

/* ------------------------------------------------------------------ */
/* distributed entry points (reference amgx_c.h:235-259,547-594)       */

AMGX_RC AMGX_resources_create(AMGX_resources_handle *res,
                              AMGX_config_handle cfg, void *comm,
                              int device_num, const int *devices) {
  (void)comm;
  (void)devices;
  ENTER();
  PyObject *r = capi_call(
      "resources_create",
      Py_BuildValue("(KOi)", (unsigned long long)cfg, Py_None,
                    device_num),
      1);
  if (!r) LEAVE_RET(rc_from_exception());
  *res = (uintptr_t)PyLong_AsUnsignedLongLong(r);
  Py_DECREF(r);
  LEAVE_RET(PyErr_Occurred() ? rc_from_exception() : AMGX_RC_OK);
}

AMGX_RC AMGX_distribution_create(AMGX_distribution_handle *dist,
                                 AMGX_config_handle cfg) {
  ENTER();
  PyObject *r = capi_call("distribution_create",
                          Py_BuildValue("(K)", (unsigned long long)cfg), 1);
  if (!r) LEAVE_RET(rc_from_exception());
  *dist = (uintptr_t)PyLong_AsUnsignedLongLong(r);
  Py_DECREF(r);
  LEAVE_RET(PyErr_Occurred() ? rc_from_exception() : AMGX_RC_OK);
}

static void dist_data_forget(uintptr_t dist);

AMGX_RC AMGX_distribution_destroy(AMGX_distribution_handle dist) {
  ENTER();
  dist_data_forget(dist);
  AMGX_RC rc = call_rc("distribution_destroy",
                       Py_BuildValue("(K)", (unsigned long long)dist), 1);
  LEAVE_RET(rc);
}

/* The partition-data length is not in the C signature (the reference
 * gets the rank count from the MPI communicator); the shim records
 * the raw pointer per distribution handle and copies the data at
 * upload time, when n_global is known.  One slot per live handle;
 * re-setting overwrites, destroy frees the slot. */
static struct {
  uintptr_t dist;
  const void *data;
  int info;
} g_dist_data[256];
static int g_dist_count = 0;

static int dist_data_find(uintptr_t dist) {
  for (int i = 0; i < g_dist_count; ++i)
    if (g_dist_data[i].dist == dist) return i;
  return -1;
}

static void dist_data_forget(uintptr_t dist) {
  int i = dist_data_find(dist);
  if (i >= 0) {
    g_dist_data[i] = g_dist_data[g_dist_count - 1];
    g_dist_count--;
  }
}

AMGX_RC AMGX_distribution_set_partition_data(
    AMGX_distribution_handle dist, AMGX_DIST_PARTITION_INFO info,
    const void *partition_data) {
  ENTER();
  int i = dist_data_find(dist);
  if (i < 0) {
    if (g_dist_count >= 256) LEAVE_RET(AMGX_RC_INTERNAL);
    i = g_dist_count++;
  }
  g_dist_data[i].dist = dist;
  g_dist_data[i].data = partition_data; /* NULL resets to default */
  g_dist_data[i].info = (int)info;
  /* record the scheme on the Python handle now; data follows at
   * upload time when sizes are known */
  AMGX_RC rc = call_rc(
      "distribution_set_partition_data",
      Py_BuildValue("(KiO)", (unsigned long long)dist, (int)info,
                    Py_None),
      1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_distribution_set_32bit_colindices(
    AMGX_distribution_handle dist, int use32bit) {
  ENTER();
  AMGX_RC rc = call_rc(
      "distribution_set_32bit_colindices",
      Py_BuildValue("(Ki)", (unsigned long long)dist, use32bit), 1);
  LEAVE_RET(rc);
}

static AMGX_RC upload_global_impl(const char *pyfn, AMGX_matrix_handle mtx,
                                  int n_global, int n, int nnz,
                                  int block_dimx, int block_dimy,
                                  const int *row_ptrs,
                                  const void *col_indices_global,
                                  const void *data, const void *diag_data,
                                  int halo_depth, int rings,
                                  const int *partition_vector,
                                  size_t col_isz) {
  int e = handle_entry(mtx);
  if (e < 0) return AMGX_RC_BAD_PARAMETERS;
  size_t msz = g_modes[e].mat_size;
  size_t vsz = msz * (size_t)nnz * block_dimx * block_dimy;
  size_t dsz = msz * (size_t)n * block_dimx * block_dimy;
  PyObject *diag = diag_data
                       ? PyBytes_FromStringAndSize((const char *)diag_data,
                                                   (Py_ssize_t)dsz)
                       : (Py_INCREF(Py_None), Py_None);
  PyObject *pv =
      partition_vector
          ? PyBytes_FromStringAndSize((const char *)partition_vector,
                                      (Py_ssize_t)(sizeof(int) *
                                                   (size_t)n_global))
          : (Py_INCREF(Py_None), Py_None);
  AMGX_RC rc = call_rc(
      pyfn,
      Py_BuildValue(
          "(Kiiiiiy#y#y#NiiN)", (unsigned long long)mtx, n_global, n, nnz,
          block_dimx, block_dimy, (const char *)row_ptrs,
          (Py_ssize_t)(sizeof(int) * (size_t)(n + 1)),
          (const char *)col_indices_global,
          (Py_ssize_t)(col_isz * (size_t)nnz), (const char *)data,
          (Py_ssize_t)vsz, diag, halo_depth, rings, pv),
      1);
  if (rc == AMGX_RC_OK) g_modes[handle_entry(mtx)].block_size = block_dimx;
  return rc;
}

AMGX_RC AMGX_matrix_upload_all_global(
    AMGX_matrix_handle mtx, int n_global, int n, int nnz, int block_dimx,
    int block_dimy, const int *row_ptrs, const void *col_indices_global,
    const void *data, const void *diag_data, int allocated_halo_depth,
    int num_import_rings, const int *partition_vector) {
  ENTER();
  AMGX_RC rc = upload_global_impl(
      "matrix_upload_all_global", mtx, n_global, n, nnz, block_dimx,
      block_dimy, row_ptrs, col_indices_global, data, diag_data,
      allocated_halo_depth, num_import_rings, partition_vector,
      sizeof(long long));
  LEAVE_RET(rc);
}

AMGX_RC AMGX_matrix_upload_all_global_32(
    AMGX_matrix_handle mtx, int n_global, int n, int nnz, int block_dimx,
    int block_dimy, const int *row_ptrs, const void *col_indices_global,
    const void *data, const void *diag_data, int allocated_halo_depth,
    int num_import_rings, const int *partition_vector) {
  ENTER();
  AMGX_RC rc = upload_global_impl(
      "matrix_upload_all_global_32", mtx, n_global, n, nnz, block_dimx,
      block_dimy, row_ptrs, col_indices_global, data, diag_data,
      allocated_halo_depth, num_import_rings, partition_vector,
      sizeof(int));
  LEAVE_RET(rc);
}

AMGX_RC AMGX_matrix_upload_distributed(
    AMGX_matrix_handle mtx, int n_global, int n, int nnz, int block_dimx,
    int block_dimy, const int *row_ptrs, const void *col_indices_global,
    const void *data, const void *diag_data,
    AMGX_distribution_handle distribution) {
  ENTER();
  /* resolve the deferred partition data now that sizes are known */
  int use32 = 0;
  {
    PyObject *r = capi_call(
        "distribution_uses_32bit",
        Py_BuildValue("(K)", (unsigned long long)distribution), 1);
    if (!r) LEAVE_RET(rc_from_exception());
    use32 = PyObject_IsTrue(r);
    Py_DECREF(r);
  }
  {
    int i = dist_data_find(distribution);
    if (i >= 0 && g_dist_data[i].data) {
      int info = g_dist_data[i].info;
      PyObject *blob;
      if (info == AMGX_DIST_PARTITION_VECTOR) {
        blob = PyBytes_FromStringAndSize(
            (const char *)g_dist_data[i].data,
            (Py_ssize_t)(sizeof(int) * (size_t)n_global));
      } else {
        /* offsets array: the C signature carries no length; scan for
         * the terminal element == n_global (offsets are nondecreasing
         * and end at n_global; element width matches the colindices
         * width).  A malformed array that never reaches n_global
         * within the 4096-rank cap is rejected. */
        size_t w = use32 ? sizeof(int) : sizeof(long long);
        const char *p = (const char *)g_dist_data[i].data;
        size_t count = 1;
        long long v = 0;
        for (; count <= 4096; ++count) {
          v = use32 ? (long long)((const int *)p)[count - 1]
                    : ((const long long *)p)[count - 1];
          if (v >= (long long)n_global) break;
        }
        if (v != (long long)n_global)
          LEAVE_RET(AMGX_RC_BAD_PARAMETERS);
        blob = PyBytes_FromStringAndSize(p, (Py_ssize_t)(w * count));
      }
      AMGX_RC rc0 = call_rc(
          "distribution_set_partition_blob",
          Py_BuildValue("(KiN)", (unsigned long long)distribution, info,
                        blob),
          1);
      if (rc0 != AMGX_RC_OK) LEAVE_RET(rc0);
    }
  }
  AMGX_RC rc;
  {
    int e = handle_entry(mtx);
    if (e < 0) LEAVE_RET(AMGX_RC_BAD_PARAMETERS);
    size_t msz = g_modes[e].mat_size;
    size_t vsz = msz * (size_t)nnz * block_dimx * block_dimy;
    size_t dsz = msz * (size_t)n * block_dimx * block_dimy;
    size_t cisz = use32 ? sizeof(int) : sizeof(long long);
    PyObject *diag =
        diag_data ? PyBytes_FromStringAndSize((const char *)diag_data,
                                              (Py_ssize_t)dsz)
                  : (Py_INCREF(Py_None), Py_None);
    rc = call_rc(
        "matrix_upload_distributed",
        Py_BuildValue(
            "(Kiiiiiy#y#y#NK)", (unsigned long long)mtx, n_global, n, nnz,
            block_dimx, block_dimy, (const char *)row_ptrs,
            (Py_ssize_t)(sizeof(int) * (size_t)(n + 1)),
            (const char *)col_indices_global,
            (Py_ssize_t)(cisz * (size_t)nnz), (const char *)data,
            (Py_ssize_t)vsz, diag, (unsigned long long)distribution),
        1);
    if (rc == AMGX_RC_OK)
      g_modes[handle_entry(mtx)].block_size = block_dimx;
  }
  LEAVE_RET(rc);
}

AMGX_RC AMGX_read_system_distributed(
    AMGX_matrix_handle mtx, AMGX_vector_handle rhs, AMGX_vector_handle sol,
    const char *filename, int allocated_halo_depth, int num_partitions,
    const int *partition_sizes, int partition_vector_size,
    const int *partition_vector) {
  (void)partition_sizes;
  ENTER();
  PyObject *pv =
      partition_vector
          ? PyBytes_FromStringAndSize(
                (const char *)partition_vector,
                (Py_ssize_t)(sizeof(int) * (size_t)partition_vector_size))
          : (Py_INCREF(Py_None), Py_None);
  AMGX_RC rc = call_rc(
      "read_system_distributed",
      Py_BuildValue("(KKKsiiOiN)", (unsigned long long)mtx,
                    (unsigned long long)rhs, (unsigned long long)sol,
                    filename, allocated_halo_depth, num_partitions,
                    Py_None, partition_vector_size, pv),
      1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_write_system_distributed(
    AMGX_matrix_handle mtx, AMGX_vector_handle rhs, AMGX_vector_handle sol,
    const char *filename, int allocated_halo_depth, int num_partitions,
    const int *partition_sizes, int partition_vector_size,
    const int *partition_vector) {
  (void)allocated_halo_depth;
  (void)num_partitions;
  (void)partition_sizes;
  (void)partition_vector_size;
  (void)partition_vector;
  ENTER();
  AMGX_RC rc = call_rc("write_system_distributed",
                       Py_BuildValue("(KKKs)", (unsigned long long)mtx,
                                     (unsigned long long)rhs,
                                     (unsigned long long)sol, filename),
                       1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_generate_distributed_poisson_7pt(
    AMGX_matrix_handle mtx, AMGX_vector_handle rhs, AMGX_vector_handle sol,
    int allocated_halo_depth, int num_import_rings, int nx, int ny, int nz,
    int px, int py, int pz) {
  (void)allocated_halo_depth;
  (void)num_import_rings;
  ENTER();
  AMGX_RC rc = call_rc(
      "generate_distributed_poisson_7pt",
      Py_BuildValue("(KKKiiiiii)", (unsigned long long)mtx,
                    (unsigned long long)rhs, (unsigned long long)sol, nx,
                    ny, nz, px, py, pz),
      1);
  LEAVE_RET(rc);
}

/* ------------------------------------------------------------------ */
/* eigensolver (reference amgx_eig_c.h)                                */

AMGX_RC AMGX_eigensolver_create(AMGX_eigensolver_handle *ret,
                                AMGX_resources_handle rsc,
                                const char *mode,
                                AMGX_config_handle cfg) {
  ENTER();
  AMGX_RC rc = create_with_mode("eig_solver_create", rsc, mode, cfg, 1,
                                ret);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_eigensolver_setup(AMGX_eigensolver_handle slv,
                               AMGX_matrix_handle mtx) {
  ENTER();
  AMGX_RC rc = call_rc("eig_solver_setup",
                       Py_BuildValue("(KK)", (unsigned long long)slv,
                                     (unsigned long long)mtx),
                       1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_eigensolver_pagerank_setup(AMGX_eigensolver_handle slv,
                                        AMGX_vector_handle a) {
  ENTER();
  AMGX_RC rc = call_rc("eig_solver_pagerank_setup",
                       Py_BuildValue("(KK)", (unsigned long long)slv,
                                     (unsigned long long)a),
                       1);
  LEAVE_RET(rc);
}

AMGX_RC AMGX_eigensolver_solve(AMGX_eigensolver_handle slv,
                               AMGX_vector_handle x) {
  ENTER();
  AMGX_RC rc = call_rc("eig_solver_solve",
                       Py_BuildValue("(KK)", (unsigned long long)slv,
                                     (unsigned long long)x),
                       1);
  if (rc == AMGX_RC_OK) {
    /* reference semantics: x receives the leading eigenvector */
    rc = call_rc("eig_solver_get_eigenvector",
                 Py_BuildValue("(KiK)", (unsigned long long)slv, 0,
                               (unsigned long long)x),
                 1);
  }
  LEAVE_RET(rc);
}

AMGX_RC AMGX_eigensolver_destroy(AMGX_eigensolver_handle slv) {
  ENTER();
  AMGX_RC rc = call_rc("eig_solver_destroy",
                       Py_BuildValue("(K)", (unsigned long long)slv), 1);
  LEAVE_RET(rc);
}

/* ------------------------------------------------------------------ */
/* one-ring comm maps (reference amgx_c.h:276-284,452-501)             */

AMGX_RC AMGX_matrix_comm_from_maps_one_ring(
    AMGX_matrix_handle mtx, int allocated_halo_depth, int num_neighbors,
    const int *neighbors, const int *send_sizes, const int **send_maps,
    const int *recv_sizes, const int **recv_maps) {
  ENTER();
  PyObject *nbrs = PyBytes_FromStringAndSize(
      (const char *)neighbors,
      (Py_ssize_t)(sizeof(int) * (size_t)num_neighbors));
  PyObject *ssz = PyBytes_FromStringAndSize(
      (const char *)send_sizes,
      (Py_ssize_t)(sizeof(int) * (size_t)num_neighbors));
  PyObject *rsz = PyBytes_FromStringAndSize(
      (const char *)recv_sizes,
      (Py_ssize_t)(sizeof(int) * (size_t)num_neighbors));
  PyObject *smaps = PyList_New(num_neighbors);
  PyObject *rmaps = PyList_New(num_neighbors);
  for (int i = 0; i < num_neighbors; ++i) {
    PyList_SetItem(
        smaps, i,
        PyBytes_FromStringAndSize(
            (const char *)send_maps[i],
            (Py_ssize_t)(sizeof(int) * (size_t)send_sizes[i])));
    PyList_SetItem(
        rmaps, i,
        PyBytes_FromStringAndSize(
            (const char *)recv_maps[i],
            (Py_ssize_t)(sizeof(int) * (size_t)recv_sizes[i])));
  }
  AMGX_RC rc = call_rc(
      "matrix_comm_from_maps_one_ring",
      Py_BuildValue("(KiiNNNNN)", (unsigned long long)mtx,
                    allocated_halo_depth, num_neighbors, nbrs, ssz,
                    smaps, rsz, rmaps),
      1);
  LEAVE_RET(rc);
}

static void *dup_bytes(PyObject *o, size_t *len_out) {
  if (o == Py_None) {
    if (len_out) *len_out = 0;
    return NULL;
  }
  Py_ssize_t len = PyBytes_Size(o);
  void *p = malloc((size_t)len > 0 ? (size_t)len : 1);
  if (p) memcpy(p, PyBytes_AsString(o), (size_t)len);
  if (len_out) *len_out = (size_t)len;
  return p;
}

AMGX_RC AMGX_read_system_maps_one_ring(
    int *n, int *nnz, int *block_dimx, int *block_dimy, int **row_ptrs,
    int **col_indices, void **data, void **diag_data, void **rhs,
    void **sol, int *num_neighbors, int **neighbors, int **send_sizes,
    int ***send_maps, int **recv_sizes, int ***recv_maps,
    AMGX_resources_handle rsc, const char *mode, const char *filename,
    int allocated_halo_depth, int num_partitions,
    const int *partition_sizes, int partition_vector_size,
    const int *partition_vector) {
  (void)partition_sizes;
  ENTER();
  PyObject *pv =
      partition_vector
          ? PyBytes_FromStringAndSize(
                (const char *)partition_vector,
                (Py_ssize_t)(sizeof(int) * (size_t)partition_vector_size))
          : (Py_INCREF(Py_None), Py_None);
  PyObject *r = capi_call(
      "read_system_maps_one_ring_flat",
      Py_BuildValue("(KssiiNi)", (unsigned long long)rsc, mode, filename,
                    allocated_halo_depth, num_partitions, pv, 0),
      1);
  if (!r) LEAVE_RET(rc_from_exception());
  PyObject *rp_o, *ci_o, *dv_o, *rhs_o, *sol_o, *nb_o, *ss_o, *sm_o,
      *rs_o, *rm_o;
  int nn;
  if (!PyArg_ParseTuple(r, "iiiiOOOOOiOOOOO", n, nnz, block_dimx,
                        block_dimy, &rp_o, &ci_o, &dv_o, &rhs_o, &sol_o,
                        &nn, &nb_o, &ss_o, &sm_o, &rs_o, &rm_o)) {
    Py_DECREF(r);
    LEAVE_RET(rc_from_exception());
  }
  *num_neighbors = nn;
  *row_ptrs = (int *)dup_bytes(rp_o, NULL);
  *col_indices = (int *)dup_bytes(ci_o, NULL);
  *data = dup_bytes(dv_o, NULL);
  if (diag_data) *diag_data = NULL;
  if (rhs) *rhs = dup_bytes(rhs_o, NULL);
  if (sol) *sol = dup_bytes(sol_o, NULL);
  *neighbors = (int *)dup_bytes(nb_o, NULL);
  *send_sizes = (int *)dup_bytes(ss_o, NULL);
  *recv_sizes = (int *)dup_bytes(rs_o, NULL);
  int *scat = (int *)dup_bytes(sm_o, NULL);
  int *rcat = (int *)dup_bytes(rm_o, NULL);
  *send_maps = (int **)malloc(sizeof(int *) * (size_t)(nn > 0 ? nn : 1));
  *recv_maps = (int **)malloc(sizeof(int *) * (size_t)(nn > 0 ? nn : 1));
  if (!*row_ptrs || !*col_indices || !*data || !*neighbors ||
      !*send_sizes || !*recv_sizes || !scat || !rcat || !*send_maps ||
      !*recv_maps || (rhs && rhs_o != Py_None && !*rhs) ||
      (sol && sol_o != Py_None && !*sol)) {
    free(*row_ptrs);
    free(*col_indices);
    free(*data);
    if (rhs) free(*rhs);
    if (sol) free(*sol);
    free(*neighbors);
    free(*send_sizes);
    free(*recv_sizes);
    free(scat);
    free(rcat);
    free(*send_maps);
    free(*recv_maps);
    Py_DECREF(r);
    LEAVE_RET(AMGX_RC_NO_MEMORY);
  }
  size_t so = 0, ro = 0;
  for (int i = 0; i < nn; ++i) {
    (*send_maps)[i] = scat + so;
    (*recv_maps)[i] = rcat + ro;
    so += (size_t)(*send_sizes)[i];
    ro += (size_t)(*recv_sizes)[i];
  }
  /* neighbor 0's pointer owns the concatenated block (freed there) */
  if (nn == 0) {
    free(scat);
    free(rcat);
    (*send_maps)[0] = NULL;
    (*recv_maps)[0] = NULL;
  }
  Py_DECREF(r);
  LEAVE_RET(AMGX_RC_OK);
}

AMGX_RC AMGX_free_system_maps_one_ring(
    int *row_ptrs, int *col_indices, void *data, void *diag_data,
    void *rhs, void *sol, int num_neighbors, int *neighbors,
    int *send_sizes, int **send_maps, int *recv_sizes, int **recv_maps) {
  free(row_ptrs);
  free(col_indices);
  free(data);
  free(diag_data);
  free(rhs);
  free(sol);
  if (send_maps) {
    if (num_neighbors > 0) free(send_maps[0]);
    free(send_maps);
  }
  if (recv_maps) {
    if (num_neighbors > 0) free(recv_maps[0]);
    free(recv_maps);
  }
  free(neighbors);
  free(send_sizes);
  free(recv_sizes);
  return AMGX_RC_OK;
}
