// C-accelerated deep copy for JSON-shaped control-plane objects.
//
// The in-process store (testing/fakekube.py) and the transport layer
// copy objects on every create/update/get/watch-notify — the analogue
// of a real apiserver's serialization boundary.  At e2e-bench scale the
// pure-Python recursion in utils/unstructured.copy_json is the single
// hottest function in the whole control plane (half the profile), so
// the same recursion is provided here as a CPython extension module.
//
// Semantics match _copy_json_fast exactly: dict/list/tuple copied
// element-wise, str/int/float/bool/None shared (immutable), dict keys
// shared, any other node raises TypeError and the Python wrapper falls
// back to copy.deepcopy for the whole call.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

static PyObject *copy_obj(PyObject *obj) {
    if (obj == Py_None || PyBool_Check(obj) || PyUnicode_CheckExact(obj) ||
        PyLong_CheckExact(obj) || PyFloat_CheckExact(obj)) {
        Py_INCREF(obj);
        return obj;
    }
    if (PyDict_CheckExact(obj)) {
        PyObject *out = PyDict_New();
        if (!out) return NULL;
        if (Py_EnterRecursiveCall(" in kadm fastcopy")) {
            Py_DECREF(out);
            return NULL;
        }
        Py_ssize_t pos = 0;
        PyObject *k, *v;
        while (PyDict_Next(obj, &pos, &k, &v)) {
            PyObject *cv = copy_obj(v);
            if (!cv || PyDict_SetItem(out, k, cv) < 0) {
                Py_XDECREF(cv);
                Py_DECREF(out);
                Py_LeaveRecursiveCall();
                return NULL;
            }
            Py_DECREF(cv);
        }
        Py_LeaveRecursiveCall();
        return out;
    }
    if (PyList_CheckExact(obj)) {
        Py_ssize_t n = PyList_GET_SIZE(obj);
        PyObject *out = PyList_New(n);
        if (!out) return NULL;
        if (Py_EnterRecursiveCall(" in kadm fastcopy")) {
            Py_DECREF(out);
            return NULL;
        }
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *cv = copy_obj(PyList_GET_ITEM(obj, i));
            if (!cv) {
                Py_DECREF(out);
                Py_LeaveRecursiveCall();
                return NULL;
            }
            PyList_SET_ITEM(out, i, cv);
        }
        Py_LeaveRecursiveCall();
        return out;
    }
    if (PyTuple_CheckExact(obj)) {
        Py_ssize_t n = PyTuple_GET_SIZE(obj);
        PyObject *out = PyTuple_New(n);
        if (!out) return NULL;
        if (Py_EnterRecursiveCall(" in kadm fastcopy")) {
            Py_DECREF(out);
            return NULL;
        }
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *cv = copy_obj(PyTuple_GET_ITEM(obj, i));
            if (!cv) {
                Py_DECREF(out);
                Py_LeaveRecursiveCall();
                return NULL;
            }
            PyTuple_SET_ITEM(out, i, cv);
        }
        Py_LeaveRecursiveCall();
        return out;
    }
    PyErr_Format(PyExc_TypeError, "non-JSON node of type %s",
                 Py_TYPE(obj)->tp_name);
    return NULL;
}

static PyObject *fastcopy(PyObject *self, PyObject *arg) {
    (void)self;
    return copy_obj(arg);
}

static PyMethodDef methods[] = {
    {"copy", fastcopy, METH_O,
     "Deep copy a JSON-shaped object (dict/list/tuple/str/int/float/bool/None)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_kadmfastcopy",
    "C deep copy for JSON-shaped objects", -1, methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__kadmfastcopy(void) { return PyModule_Create(&moduledef); }
