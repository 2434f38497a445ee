/* Containers of the native history scanners (histscan.c): growable byte
 * buffers, the (f, a, b, ok) -> uop id interning table, and the table
 * that gives each client process a dense id.  Everything here runs under
 * the GIL and allocates with PyMem. */
#ifndef JEPSEN_TPU_TORCH_SCANCOMMON_H
#define JEPSEN_TPU_TORCH_SCANCOMMON_H

#include <Python.h>
#include <stdint.h>
#include <string.h>

/* A growable byte buffer; len and cap count bytes. */
typedef struct {
    char *data;
    Py_ssize_t len, cap;
} buf;

static int buf_reserve(buf *b, Py_ssize_t extra) {
    if (b->len + extra <= b->cap) return 0;
    Py_ssize_t ncap = b->cap ? b->cap : 1024;
    while (ncap < b->len + extra) ncap *= 2;
    char *nd = PyMem_Realloc(b->data, ncap);
    if (!nd) {
        PyErr_NoMemory();
        return -1;
    }
    b->data = nd;
    b->cap = ncap;
    return 0;
}

static inline int push_i32(buf *b, int32_t x) {
    if (b->len + 4 > b->cap && buf_reserve(b, 4) < 0) return -1;
    memcpy(b->data + b->len, &x, 4);
    b->len += 4;
    return 0;
}

static inline int push_i64(buf *b, int64_t x) {
    if (b->len + 8 > b->cap && buf_reserve(b, 8) < 0) return -1;
    memcpy(b->data + b->len, &x, 8);
    b->len += 8;
    return 0;
}

static inline int32_t i32_at(const buf *b, Py_ssize_t k) {
    int32_t x;
    memcpy(&x, b->data + 4 * k, 4);
    return x;
}

static PyObject *buf_bytes(const buf *b) {
    return PyBytes_FromStringAndSize(b->len ? b->data : NULL, b->len);
}

static void buf_free(buf *b) {
    PyMem_Free(b->data);
    b->data = NULL;
    b->len = b->cap = 0;
}

/* Open addressing over int64 keys (an empty entry has v < 0). */
typedef struct { int64_t k; long v; } hent;
typedef struct { hent *e; long cap, n; } htab;

static int htab_init(htab *t, long want) {
    long c = 64;
    while (c < 2 * want) c <<= 1;
    t->e = PyMem_Malloc(c * sizeof(hent));
    if (!t->e) {
        PyErr_NoMemory();
        return -1;
    }
    for (long i = 0; i < c; i++) t->e[i].v = -1;
    t->cap = c;
    t->n = 0;
    return 0;
}

static inline uint64_t mix64(uint64_t h) {
    h ^= h >> 33;
    h *= 0xff51afd7ed558ccdULL;
    h ^= h >> 33;
    h *= 0xc4ceb9fe1a85ec53ULL;
    h ^= h >> 33;
    return h;
}

static inline long htab_slot(const htab *t, int64_t k) {
    uint64_t m = (uint64_t)t->cap - 1;
    uint64_t i = mix64((uint64_t)k) & m;
    while (t->e[i].v >= 0 && t->e[i].k != k) i = (i + 1) & m;
    return (long)i;
}

/* The value of key k, inserting `fresh` first when k is missing. */
static long htab_get_or_add(htab *t, int64_t k, long fresh) {
    long s = htab_slot(t, k);
    if (t->e[s].v >= 0) return t->e[s].v;
    t->e[s].k = k;
    t->e[s].v = fresh;
    if (++t->n * 2 > t->cap) {
        hent *old = t->e;
        long ocap = t->cap;
        t->e = PyMem_Malloc(2 * ocap * sizeof(hent));
        if (!t->e) {
            t->e = old;
            PyErr_NoMemory();
            return -1;
        }
        t->cap = 2 * ocap;
        for (long i = 0; i < t->cap; i++) t->e[i].v = -1;
        for (long i = 0; i < ocap; i++)
            if (old[i].v >= 0) t->e[htab_slot(t, old[i].k)] = old[i];
        PyMem_Free(old);
    }
    return fresh;
}

/* The uop interning table: key (f, a, b, ok) -> dense uop id. */
typedef struct { int64_t f, a, b, ok; long u; } uent;
typedef struct { uent *e; long cap, n; } utab;

static int utab_init(utab *t) {
    t->cap = 256;
    t->n = 0;
    t->e = PyMem_Malloc(t->cap * sizeof(uent));
    if (!t->e) {
        PyErr_NoMemory();
        return -1;
    }
    for (long i = 0; i < t->cap; i++) t->e[i].u = -1;
    return 0;
}

static inline long utab_slot(const utab *t, int64_t f, int64_t a,
                             int64_t b, int64_t ok) {
    uint64_t m = (uint64_t)t->cap - 1;
    uint64_t h = mix64((uint64_t)f * 0x9E3779B97F4A7C15ULL
                       ^ mix64((uint64_t)a + 0x632BE59BD9B4E019ULL)
                       ^ mix64((uint64_t)b ^ ((uint64_t)ok << 62)));
    uint64_t i = h & m;
    for (;;) {
        const uent *e = &t->e[i];
        if (e->u < 0 || (e->f == f && e->a == a && e->b == b
                         && e->ok == ok))
            return (long)i;
        i = (i + 1) & m;
    }
}

static int utab_grow(utab *t) {
    uent *old = t->e;
    long ocap = t->cap;
    t->e = PyMem_Malloc(2 * ocap * sizeof(uent));
    if (!t->e) {
        t->e = old;
        PyErr_NoMemory();
        return -1;
    }
    t->cap = 2 * ocap;
    for (long i = 0; i < t->cap; i++) t->e[i].u = -1;
    for (long i = 0; i < ocap; i++)
        if (old[i].u >= 0)
            t->e[utab_slot(t, old[i].f, old[i].a, old[i].b, old[i].ok)] =
                old[i];
    PyMem_Free(old);
    return 0;
}

/* The interning key as the Python scan builds it: (f, a, b, ok) with ok
 * a bool. */
static PyObject *uop_key(long f, long a, long b, int ok) {
    PyObject *t = PyTuple_New(4);
    if (!t) return NULL;
    PyObject *x0 = PyLong_FromLong(f), *x1 = PyLong_FromLong(a),
             *x2 = PyLong_FromLong(b), *x3 = PyBool_FromLong(ok);
    if (!x0 || !x1 || !x2 || !x3) {
        Py_XDECREF(x0);
        Py_XDECREF(x1);
        Py_XDECREF(x2);
        Py_XDECREF(x3);
        Py_DECREF(t);
        return NULL;
    }
    PyTuple_SET_ITEM(t, 0, x0);
    PyTuple_SET_ITEM(t, 1, x1);
    PyTuple_SET_ITEM(t, 2, x2);
    PyTuple_SET_ITEM(t, 3, x3);
    return t;
}

/* The uop id of (f, a, b, ok): from this scan's table, else from the
 * caller's `seen`, else a new id after `base_rows` rows and the keys
 * staged in `new_rows` (published only when the scan succeeds).
 * Returns -1 with a Python error set on failure. */
static long intern_uop(utab *ut, PyObject *seen, int seen_nonempty,
                       Py_ssize_t base_rows, PyObject *new_rows,
                       long f, long a, long b, int ok) {
    long s = utab_slot(ut, f, a, b, ok);
    if (ut->e[s].u >= 0) return ut->e[s].u;
    long u = -1;
    PyObject *key = uop_key(f, a, b, ok);
    if (!key) return -1;
    if (seen_nonempty) {
        PyObject *uo = PyDict_GetItemWithError(seen, key);
        if (uo) {
            u = PyLong_AsLong(uo);
            if (u == -1 && PyErr_Occurred()) {
                Py_DECREF(key);
                return -1;
            }
        } else if (PyErr_Occurred()) {
            Py_DECREF(key);
            return -1;
        }
    }
    if (u < 0) {
        u = (long)(base_rows + PyList_GET_SIZE(new_rows));
        if (PyList_Append(new_rows, key) < 0) {
            Py_DECREF(key);
            return -1;
        }
    }
    Py_DECREF(key);
    uent *e = &ut->e[s];
    e->f = f;
    e->a = a;
    e->b = b;
    e->ok = ok;
    e->u = u;
    if (++ut->n * 2 > ut->cap && utab_grow(ut) < 0) return -1;
    return u;
}

/* Publish the staged keys: seen[key] = id, rows.append(key). */
static int publish_interning(PyObject *seen, PyObject *rows,
                             PyObject *new_rows, Py_ssize_t base_rows) {
    Py_ssize_t m = PyList_GET_SIZE(new_rows);
    for (Py_ssize_t i = 0; i < m; i++) {
        PyObject *key = PyList_GET_ITEM(new_rows, i);
        PyObject *uu = PyLong_FromSsize_t(base_rows + i);
        int r = uu ? PyDict_SetItem(seen, key, uu) : -1;
        Py_XDECREF(uu);
        if (r < 0 || PyList_Append(rows, key) < 0) return -1;
    }
    return 0;
}

#endif /* JEPSEN_TPU_TORCH_SCANCOMMON_H */
