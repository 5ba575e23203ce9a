/* C ABI of the PyTorch / CUDA port (`parmmg_tpu_torch`).
 *
 * The same exported functions, with the same signatures, as the JAX
 * package's `native/parmmg_capi.c`, so that a foreign program switches
 * between the two by linking the other library (never both: the names
 * are the same). This thin embedded-CPython shim drives
 * `parmmg_tpu_torch.api` through `parmmg_tpu_torch.capi_support`, which
 * holds the byte-buffer conversions and the device (default: the GPU).
 * A C or Fortran caller needs the repository root (and the site
 * packages that hold torch) on PYTHONPATH; its embedded interpreter
 * imports torch and initialises CUDA itself.
 *
 * Built at first use by `parmmg_tpu_torch.native.capi_library()` (gcc,
 * against this interpreter's headers, linking its libpython where that
 * is a shared library) into `parmmg_tpu_torch/_build/`.
 *
 * Fortran usage sketch (ISO_C_BINDING):
 *
 *   interface
 *     integer(c_int) function pmmgtpu_adapt_file(inmesh, insol, out, &
 *         hsiz, niter, nparts) bind(c, name="pmmgtpu_adapt_file")
 *       use iso_c_binding
 *       character(kind=c_char), dimension(*) :: inmesh, insol, out
 *       real(c_double), value :: hsiz
 *       integer(c_int), value :: niter, nparts
 *     end function
 *   end interface
 *
 * Returns the graded status of the run: 0 = PMMG_SUCCESS,
 * 1 = PMMG_LOWFAILURE (conformal mesh was still saved),
 * 2 = PMMG_STRONGFAILURE (reference `src/libparmmgtypes.h:45-66`).
 */

#include <Python.h>
#include <pthread.h>
#include <string.h>

static pthread_mutex_t init_lock = PTHREAD_MUTEX_INITIALIZER;

static int ensure_python(void) {
    /* mutex-guarded (NOT pthread_once): concurrent first calls from
     * multiple foreign threads must not race Py_InitializeEx, but a
     * failed init (e.g. a PYTHONHOME the host app fixes later) must
     * stay retryable on the next call */
    int ok;
    pthread_mutex_lock(&init_lock);
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        if (Py_IsInitialized()) {
            /* release the GIL the interpreter holds after init, so
             * later PyGILState_Ensure calls (from ANY caller thread)
             * can acquire it instead of deadlocking */
            PyEval_SaveThread();
        }
    }
    ok = Py_IsInitialized();
    pthread_mutex_unlock(&init_lock);
    return ok ? 0 : -1;
}

static PyObject *capi_mod(void) {
    return PyImport_ImportModule("parmmg_tpu_torch.capi_support");
}

/* Adapt `inmesh` (Medit ASCII) to the metric in `insol` (may be NULL or
 * "" for -optim implied sizes), writing `outmesh`. hsiz <= 0 means "use
 * the sol metric"; nparts > 1 runs the distributed driver. */
int pmmgtpu_adapt_file(const char *inmesh, const char *insol,
                       const char *outmesh, double hsiz, int niter,
                       int nparts) {
    PyGILState_STATE g;
    PyObject *mod = NULL, *fn = NULL, *res = NULL;
    int rc = 2; /* STRONGFAILURE until proven otherwise */

    if (ensure_python() != 0) return 2;
    g = PyGILState_Ensure();

    mod = capi_mod();
    if (!mod) goto done;
    fn = PyObject_GetAttrString(mod, "adapt_file");
    if (!fn) goto done;
    res = PyObject_CallFunction(
        fn, "sssdii",
        inmesh,
        (insol && insol[0]) ? insol : "",
        outmesh, hsiz, niter, nparts);
    if (!res) goto done;
    rc = (int)PyLong_AsLong(res);
    if (PyErr_Occurred()) rc = 2;

done:
    if (PyErr_Occurred()) PyErr_Print();
    Py_XDECREF(res);
    Py_XDECREF(fn);
    Py_XDECREF(mod);
    PyGILState_Release(g);
    return rc;
}

/* ------------------------------------------------------------------ */
/* Staged-arrays surface: the PMMG_Init_parMesh / PMMG_Set_* /
 * PMMG_parmmglib_centralized / PMMG_Get_* workflow for foreign callers
 * holding raw buffers (the `src/API_functions_pmmg.c` role). Entity
 * indices cross this ABI 1-BASED like the reference API. The handle is
 * an opaque pointer; every call is GIL-safe from any thread.
 * Conversions live in `parmmg_tpu_torch/capi_support.py`. */

/* Create a parmesh handle (nparts > 1 = distributed driver). NULL on
 * failure. Release with pmmgtpu_free. */
void *pmmgtpu_init(int nparts) {
    PyGILState_STATE g;
    PyObject *mod = NULL, *pm = NULL;
    if (ensure_python() != 0) return NULL;
    g = PyGILState_Ensure();
    mod = capi_mod();
    if (mod)
        pm = PyObject_CallMethod(mod, "make_parmesh", "i", nparts);
    if (PyErr_Occurred()) PyErr_Print();
    Py_XDECREF(mod);
    PyGILState_Release(g);
    return (void *)pm; /* owned reference held by the caller's handle */
}

int pmmgtpu_free(void *h) {
    PyGILState_STATE g;
    if (!h) return 0;
    g = PyGILState_Ensure();
    Py_DECREF((PyObject *)h);
    PyGILState_Release(g);
    return 0;
}

/* Shared call helper: method(pm, bytes(buf1), bytes(buf2)|None, n)
 * for the entity setters. refs may be NULL. */
static int capi_set_entities(void *h, const char *meth, const void *buf,
                             size_t nbytes, const int *refs, int n) {
    PyGILState_STATE g;
    PyObject *mod = NULL, *res = NULL, *b = NULL, *r = NULL;
    int rc = -1;
    if (!h) return -1;
    if (ensure_python() != 0) return -1;
    g = PyGILState_Ensure();
    mod = capi_mod();
    if (!mod) goto done;
    b = PyBytes_FromStringAndSize((const char *)buf, (Py_ssize_t)nbytes);
    if (!b) goto done;
    if (refs) {
        r = PyBytes_FromStringAndSize((const char *)refs,
                                      (Py_ssize_t)(sizeof(int) * (size_t)n));
        if (!r) goto done;
    } else {
        r = Py_None;
        Py_INCREF(Py_None);
    }
    res = PyObject_CallMethod(mod, meth, "OOOi", (PyObject *)h, b, r, n);
    if (res) rc = (int)PyLong_AsLong(res);
    if (PyErr_Occurred()) rc = -1;
done:
    if (PyErr_Occurred()) PyErr_Print();
    Py_XDECREF(res);
    Py_XDECREF(r);
    Py_XDECREF(b);
    Py_XDECREF(mod);
    PyGILState_Release(g);
    return rc;
}

/* coords: np x 3 doubles (C order); refs: np ints or NULL */
int pmmgtpu_set_vertices(void *h, const double *coords, const int *refs,
                         int np) {
    return capi_set_entities(h, "set_vertices", coords,
                             sizeof(double) * 3u * (size_t)np, refs, np);
}

/* tets: ne x 4 ints, 1-BASED vertex ids; refs: ne ints or NULL */
int pmmgtpu_set_tetrahedra(void *h, const int *tets, const int *refs,
                           int ne) {
    return capi_set_entities(h, "set_tetrahedra", tets,
                             sizeof(int) * 4u * (size_t)ne, refs, ne);
}

/* trias: nt x 3 ints, 1-BASED vertex ids; refs: nt ints or NULL */
int pmmgtpu_set_triangles(void *h, const int *trias, const int *refs,
                          int nt) {
    return capi_set_entities(h, "set_triangles", trias,
                             sizeof(int) * 3u * (size_t)nt, refs, nt);
}

/* met: np x ncomp doubles; ncomp 1 (iso) or 6 (aniso tensor) */
int pmmgtpu_set_metric(void *h, const double *met, int np, int ncomp) {
    PyGILState_STATE g;
    PyObject *mod = NULL, *res = NULL, *b = NULL;
    int rc = -1;
    if (!h) return -1;
    if (ensure_python() != 0) return -1;
    g = PyGILState_Ensure();
    mod = capi_mod();
    if (mod) {
        b = PyBytes_FromStringAndSize(
            (const char *)met,
            (Py_ssize_t)(sizeof(double) * (size_t)np * (size_t)ncomp));
        if (b)
            res = PyObject_CallMethod(mod, "set_metric", "OOii",
                                      (PyObject *)h, b, np, ncomp);
        if (res) rc = (int)PyLong_AsLong(res);
        if (PyErr_Occurred()) rc = -1;
    }
    if (PyErr_Occurred()) PyErr_Print();
    Py_XDECREF(res);
    Py_XDECREF(b);
    Py_XDECREF(mod);
    PyGILState_Release(g);
    return rc;
}

/* param enums match parmmg_tpu_torch.api.Param (documented there). */
int pmmgtpu_set_iparameter(void *h, int param, int value) {
    PyGILState_STATE g;
    PyObject *mod = NULL, *res = NULL;
    int rc = -1;
    if (!h || ensure_python() != 0) return -1;
    g = PyGILState_Ensure();
    mod = capi_mod();
    if (mod)
        res = PyObject_CallMethod(mod, "set_iparameter", "Oii",
                                  (PyObject *)h, param, value);
    if (res) rc = (int)PyLong_AsLong(res);
    if (PyErr_Occurred()) { PyErr_Print(); rc = -1; }
    Py_XDECREF(res);
    Py_XDECREF(mod);
    PyGILState_Release(g);
    return rc;
}

int pmmgtpu_set_dparameter(void *h, int param, double value) {
    PyGILState_STATE g;
    PyObject *mod = NULL, *res = NULL;
    int rc = -1;
    if (!h || ensure_python() != 0) return -1;
    g = PyGILState_Ensure();
    mod = capi_mod();
    if (mod)
        res = PyObject_CallMethod(mod, "set_dparameter", "Oid",
                                  (PyObject *)h, param, value);
    if (res) rc = (int)PyLong_AsLong(res);
    if (PyErr_Occurred()) { PyErr_Print(); rc = -1; }
    Py_XDECREF(res);
    Py_XDECREF(mod);
    PyGILState_Release(g);
    return rc;
}

/* Run the centralized pipeline on the staged mesh. Returns graded
 * status (0/1/2 like pmmgtpu_adapt_file). */
int pmmgtpu_run(void *h) {
    PyGILState_STATE g;
    PyObject *mod = NULL, *res = NULL;
    int rc = 2;
    if (!h || ensure_python() != 0) return 2;
    g = PyGILState_Ensure();
    mod = capi_mod();
    if (mod)
        res = PyObject_CallMethod(mod, "run", "O", (PyObject *)h);
    if (res) rc = (int)PyLong_AsLong(res);
    if (PyErr_Occurred()) { PyErr_Print(); rc = 2; }
    Py_XDECREF(res);
    Py_XDECREF(mod);
    PyGILState_Release(g);
    return rc;
}

/* Result sizes, for the caller to allocate get_* buffers. */
int pmmgtpu_get_meshsize(void *h, int *np, int *ne, int *nt) {
    PyGILState_STATE g;
    PyObject *mod = NULL, *res = NULL;
    int rc = -1;
    if (!h || ensure_python() != 0) return -1;
    g = PyGILState_Ensure();
    mod = capi_mod();
    if (mod)
        res = PyObject_CallMethod(mod, "get_mesh_size", "O", (PyObject *)h);
    if (res && PyArg_ParseTuple(res, "iii", np, ne, nt)) rc = 0;
    if (PyErr_Occurred()) { PyErr_Print(); rc = -1; }
    Py_XDECREF(res);
    Py_XDECREF(mod);
    PyGILState_Release(g);
    return rc;
}

/* Shared getter: calls `meth` returning (data_bytes, refs_bytes) and
 * memcpy's into caller buffers (either may be NULL to skip). */
static int capi_get_pair(void *h, const char *meth, void *data,
                         size_t dbytes, int *refs, size_t rbytes) {
    PyGILState_STATE g;
    PyObject *mod = NULL, *res = NULL;
    int rc = -1;
    if (!h || ensure_python() != 0) return -1;
    g = PyGILState_Ensure();
    mod = capi_mod();
    if (mod)
        res = PyObject_CallMethod(mod, meth, "O", (PyObject *)h);
    if (res && PyTuple_Check(res) && PyTuple_GET_SIZE(res) == 2) {
        PyObject *d = PyTuple_GET_ITEM(res, 0);
        PyObject *r = PyTuple_GET_ITEM(res, 1);
        rc = 0;
        if (data) {
            if ((size_t)PyBytes_GET_SIZE(d) == dbytes)
                memcpy(data, PyBytes_AS_STRING(d), dbytes);
            else rc = -1;
        }
        if (refs && rc == 0) {
            if ((size_t)PyBytes_GET_SIZE(r) == rbytes)
                memcpy(refs, PyBytes_AS_STRING(r), rbytes);
            else rc = -1;
        }
    }
    if (PyErr_Occurred()) { PyErr_Print(); rc = -1; }
    Py_XDECREF(res);
    Py_XDECREF(mod);
    PyGILState_Release(g);
    return rc;
}

int pmmgtpu_get_vertices(void *h, double *coords, int *refs, int np) {
    return capi_get_pair(h, "get_vertices", coords,
                         sizeof(double) * 3u * (size_t)np, refs,
                         sizeof(int) * (size_t)np);
}

/* tets out 1-BASED */
int pmmgtpu_get_tetrahedra(void *h, int *tets, int *refs, int ne) {
    return capi_get_pair(h, "get_tetrahedra", tets,
                         sizeof(int) * 4u * (size_t)ne, refs,
                         sizeof(int) * (size_t)ne);
}

/* trias out 1-BASED */
int pmmgtpu_get_triangles(void *h, int *trias, int *refs, int nt) {
    return capi_get_pair(h, "get_triangles", trias,
                         sizeof(int) * 3u * (size_t)nt, refs,
                         sizeof(int) * (size_t)nt);
}

int pmmgtpu_get_metric(void *h, double *met, int np, int ncomp) {
    PyGILState_STATE g;
    PyObject *mod = NULL, *res = NULL;
    int rc = -1;
    if (!h || ensure_python() != 0) return -1;
    g = PyGILState_Ensure();
    mod = capi_mod();
    if (mod)
        res = PyObject_CallMethod(mod, "get_metric", "O", (PyObject *)h);
    if (res && PyBytes_Check(res)) {
        size_t want = sizeof(double) * (size_t)np * (size_t)ncomp;
        if ((size_t)PyBytes_GET_SIZE(res) == want) {
            memcpy(met, PyBytes_AS_STRING(res), want);
            rc = 0;
        }
    }
    if (PyErr_Occurred()) { PyErr_Print(); rc = -1; }
    Py_XDECREF(res);
    Py_XDECREF(mod);
    PyGILState_Release(g);
    return rc;
}

/* Library version string, naming the port (static storage, do not
 * free). */
const char *pmmgtpu_version(void) {
    static char buf[64] = "";
    PyGILState_STATE g;
    PyObject *mod = NULL, *v = NULL;

    if (buf[0]) return buf;
    if (ensure_python() != 0) return "unknown";
    g = PyGILState_Ensure();
    mod = capi_mod();
    if (mod) {
        v = PyObject_CallMethod(mod, "version", NULL);
        if (v) {
            const char *s = PyUnicode_AsUTF8(v);
            if (s) {
                strncpy(buf, s, sizeof(buf) - 1);
            }
        }
    }
    if (PyErr_Occurred()) PyErr_Clear();
    Py_XDECREF(v);
    Py_XDECREF(mod);
    PyGILState_Release(g);
    return buf[0] ? buf : "unknown";
}
