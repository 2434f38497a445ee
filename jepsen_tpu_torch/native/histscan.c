/* The native history scan (a CPython extension): pairing, slot
 * assignment and op interning in one pass over one history, the C form
 * of `jepsen_tpu_torch.ops.planner._fast_scan` for a history without
 * crashed calls.  Its output equals that scan's field for field, and
 * `tests/test_torch_histscan.py` holds it so.
 *
 * Three entry points read the history in two forms:
 *
 *   fast_scan(ops, f_codes, seen, rows, max_open_bits)
 *       over a list of Op objects (attributes process, type, f, value);
 *   fast_scan_cols(proc, typ, fmap, va, vb, vkind, seen, rows,
 *                  max_open_bits[, want_snaps])
 *       over the columns of a PackedHistory: proc i32, typ u8 (0 invoke,
 *       1 ok, 2 fail, 3 info), fmap i32 (each op's model f-code, -1 for
 *       none), va and vb i32 (the value slots), vkind u8 (0 None, 1 int,
 *       2 pair, 3 other, 4 outside int32);
 *   fast_scan_streams(proc, typ, fmap, va, vb, vkind, seen, rows,
 *                     max_open_bits, target)
 *       the column scan that also cuts the history into segments (a
 *       segment closes at the first quiescent return at least `target`
 *       returns in, as planner._segment_ends does) and writes each
 *       segment's wire as `regs_kernel.pack_stream(fk, seg_ends, 1)`
 *       does: ret+1 u8[L], islot+1 u8[2L], iuop u16-LE[2L], one invoke a
 *       row (the second column empty), a return's new invokes in
 *       invocation order, all but the last on rows of their own before
 *       the return's row.
 *
 * Each returns (0, result) or, where the history is outside the scan,
 * (reason, position) with one of the REFUSE_ codes below; the wrapper
 * raises what the Python scan raises for it.  `seen` and `rows` (the
 * interning shared across histories) change only on success.
 *
 * fast_scan and fast_scan_cols return (n_calls, max_open, ret_slots,
 * cand_counts, cand_slots, cand_uops, cuts, d_counts, d_slots, d_uops,
 * positions), each array as the bytes of an int32 array: per return its
 * slot, the size of its open set, the open set's (slot, uop) pairs in
 * invocation order (empty with want_snaps = 0), whether no call stays
 * open after it, the number of calls invoked since the previous return
 * and their (slot, uop) pairs in invocation order, and its position in
 * the history.  fast_scan_streams returns (n_calls, max_open, n_rets,
 * wire u8, offs i64[K], nrows i32[K], seg_ends i32[K], positions). */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#include "scancommon.h"

enum {
    REFUSE_DOUBLE_INVOKE = 1,  /* position: the second invoke */
    REFUSE_UNRETURNED = 2,     /* an invoke has no completion */
    REFUSE_CRASHED = 3,        /* position: an invoke completed by :info */
    REFUSE_NO_FCODE = 4,       /* position: the invoke */
    REFUSE_VALUE_RANGE = 5,    /* position: the op whose value is used */
    REFUSE_DEPTH = 6,          /* more than max_open_bits calls open */
    REFUSE_COLUMNS = 7,        /* a client process outside int32: the
                                * columns cannot name it (P_OUT_OF_RANGE) */
};

#define P_OUT_OF_RANGE (-2)
#define KIND_OTHER 4           /* a type other than the four */

static PyObject *s_process, *s_type, *s_f, *s_value;
static PyObject *t_names[4];   /* invoke, ok, fail, info */

/* One history as the shared pass reads it: per op its client's dense id
 * (-1 for an op that is not a client call), its kind, and for each
 * invoke the position of its completion. */
typedef struct {
    Py_ssize_t n, n_pid;
    int32_t *pid;
    int8_t *kind;
    Py_ssize_t *fate;
    /* the column form; NULL for the object form */
    const int32_t *fmap, *va, *vb;
    const uint8_t *vk;
    /* the object form */
    PyObject *ops, *f_codes;
} scan_in;

typedef struct {
    long n_calls, max_open, n_rets;
    buf rs, counts, cs, cu, cuts, dc, ds, du, pos;
    /* the segment wire (stream scan) */
    buf wire, offs, nrows, seg_ends, row_ret, row_slot, row_uop;
} scan_out;

static void scan_out_free(scan_out *o) {
    buf *all[] = {&o->rs, &o->counts, &o->cs, &o->cu, &o->cuts, &o->dc,
                  &o->ds, &o->du, &o->pos, &o->wire, &o->offs, &o->nrows,
                  &o->seg_ends, &o->row_ret, &o->row_slot, &o->row_uop};
    for (size_t i = 0; i < sizeof(all) / sizeof(all[0]); i++)
        buf_free(all[i]);
}

static void scan_in_free(scan_in *in) {
    PyMem_Free(in->pid);
    PyMem_Free(in->kind);
    PyMem_Free(in->fate);
}

static int scan_in_alloc(scan_in *in, Py_ssize_t n) {
    Py_ssize_t m = n ? n : 1;
    in->n = n;
    in->pid = PyMem_Malloc(m * sizeof(int32_t));
    in->kind = PyMem_Malloc(m * sizeof(int8_t));
    in->fate = PyMem_Malloc(m * sizeof(Py_ssize_t));
    if (!in->pid || !in->kind || !in->fate) {
        PyErr_NoMemory();
        return -1;
    }
    for (Py_ssize_t i = 0; i < n; i++) in->fate[i] = -1;
    return 0;
}

/* Pairing (the Python scan's pass 1), over the dense ids: each
 * completion of any type closes its process's open invoke.  Returns 0,
 * a REFUSE_ code with *at set, or -1 on error. */
static int pair_calls(scan_in *in, Py_ssize_t *at) {
    Py_ssize_t *open = PyMem_Malloc((in->n_pid ? in->n_pid : 1)
                                    * sizeof(Py_ssize_t));
    if (!open) {
        PyErr_NoMemory();
        return -1;
    }
    for (Py_ssize_t d = 0; d < in->n_pid; d++) open[d] = -1;
    Py_ssize_t n_open = 0;
    int why = 0;
    for (Py_ssize_t i = 0; i < in->n; i++) {
        int32_t d = in->pid[i];
        if (d < 0) continue;
        if (in->kind[i] == 0) {
            if (open[d] >= 0) {
                why = REFUSE_DOUBLE_INVOKE;
                *at = i;
                break;
            }
            open[d] = i;
            n_open++;
        } else if (open[d] >= 0) {
            in->fate[open[d]] = i;
            open[d] = -1;
            n_open--;
        }
    }
    if (!why && n_open > 0) {
        why = REFUSE_UNRETURNED;
        *at = -1;
    }
    PyMem_Free(open);
    return why;
}

/* A value as the Python scan encodes it: 1 with (a, b, ok), 0 when it
 * lies outside int32, -1 on error. */
static int encode_value(PyObject *v, long *a, long *b, int *ok) {
    *a = 0;
    *b = 0;
    *ok = 0;
    if (PyBool_Check(v)) {
        *a = (v == Py_True);
        *ok = 1;
        return 1;
    }
    if (PyLong_Check(v)) {
        int over = 0;
        long long x = PyLong_AsLongLongAndOverflow(v, &over);
        if (x == -1 && PyErr_Occurred()) return -1;
        if (over || x < -2147483648LL || x >= 2147483648LL) return 0;
        *a = (long)x;
        *ok = 1;
        return 1;
    }
    if ((PyList_Check(v) || PyTuple_Check(v))
        && PySequence_Fast_GET_SIZE(v) == 2) {
        PyObject *x0 = PySequence_Fast_GET_ITEM(v, 0);
        PyObject *x1 = PySequence_Fast_GET_ITEM(v, 1);
        if (!PyLong_Check(x0) || !PyLong_Check(x1) || PyBool_Check(x0)
            || PyBool_Check(x1))
            return 1;
        int o0 = 0, o1 = 0;
        long long y0 = PyLong_AsLongLongAndOverflow(x0, &o0);
        if (y0 == -1 && PyErr_Occurred()) return -1;
        long long y1 = PyLong_AsLongLongAndOverflow(x1, &o1);
        if (y1 == -1 && PyErr_Occurred()) return -1;
        if (o0 || o1 || y0 < -2147483648LL || y0 >= 2147483648LL
            || y1 < -2147483648LL || y1 >= 2147483648LL)
            return 0;
        *a = (long)y0;
        *b = (long)y1;
        *ok = 1;
    }
    return 1;
}

/* The call invoked at i and completed at ci as (f, a, b, ok), checked
 * in the Python scan's order: the f-code, then the value's range.
 * Returns 0, a REFUSE_ code with *at set, or -1 on error. */
static int encode_call(const scan_in *in, Py_ssize_t i, Py_ssize_t ci,
                       long *fc, long *a, long *b, int *ok,
                       Py_ssize_t *at) {
    if (in->fmap) {
        *fc = in->fmap[i];
        if (*fc < 0) {
            *at = i;
            return REFUSE_NO_FCODE;
        }
        uint8_t k = in->vk[i];
        Py_ssize_t vi = i;
        if (k == 0) {                  /* a None invoke: the completion's */
            k = in->vk[ci];
            vi = ci;
        }
        if (k == 4) {
            *at = vi;
            return REFUSE_VALUE_RANGE;
        }
        if (k == 1 || k == 2) {
            *a = in->va[vi];
            *b = k == 2 ? in->vb[vi] : 0;
            *ok = 1;
        } else {
            *a = 0;
            *b = 0;
            *ok = 0;
        }
        return 0;
    }
    PyObject *op = PyList_GET_ITEM(in->ops, i);
    Py_ssize_t vi = i;
    PyObject *v = PyObject_GetAttr(op, s_value);
    if (!v) return -1;
    if (v == Py_None) {
        Py_DECREF(v);
        vi = ci;
        v = PyObject_GetAttr(PyList_GET_ITEM(in->ops, ci), s_value);
        if (!v) return -1;
    }
    PyObject *f = PyObject_GetAttr(op, s_f);
    if (!f) {
        Py_DECREF(v);
        return -1;
    }
    PyObject *fco = PyDict_GetItemWithError(in->f_codes, f);
    Py_DECREF(f);
    *fc = -1;
    if (fco) {
        *fc = PyLong_AsLong(fco);
        if (*fc == -1 && PyErr_Occurred()) {
            Py_DECREF(v);
            return -1;
        }
    } else if (PyErr_Occurred()) {
        Py_DECREF(v);
        return -1;
    }
    if (*fc < 0) {
        Py_DECREF(v);
        *at = i;
        return REFUSE_NO_FCODE;
    }
    int e = encode_value(v, a, b, ok);
    Py_DECREF(v);
    if (e < 0) return -1;
    if (e == 0) {
        *at = vi;
        return REFUSE_VALUE_RANGE;
    }
    return 0;
}

/* One row of the open segment's wire. */
static inline int put_row(scan_out *o, int32_t ret, int32_t slot,
                          int32_t uop) {
    if (push_i32(&o->row_ret, ret) < 0 || push_i32(&o->row_slot, slot) < 0
        || push_i32(&o->row_uop, uop) < 0)
        return -1;
    return 0;
}

/* Close a segment over its first L rows: write them in the wire layout
 * and drop every row of the open segment. */
static int close_segment(scan_out *o, Py_ssize_t L, long seg_end) {
    Py_ssize_t base = o->wire.len;
    if (push_i64(&o->offs, (int64_t)base) < 0
        || push_i32(&o->nrows, (int32_t)L) < 0
        || push_i32(&o->seg_ends, (int32_t)seg_end) < 0
        || buf_reserve(&o->wire, 7 * L) < 0)
        return -1;
    unsigned char *w = (unsigned char *)o->wire.data + base;
    memset(w, 0, 7 * L);
    for (Py_ssize_t r = 0; r < L; r++) {
        int32_t slot = i32_at(&o->row_slot, r);
        uint32_t uop = (uint32_t)i32_at(&o->row_uop, r);
        w[r] = (unsigned char)(i32_at(&o->row_ret, r) + 1);
        w[L + 2 * r] = (unsigned char)(slot + 1);
        w[3 * L + 4 * r] = (unsigned char)(uop & 0xFF);
        w[3 * L + 4 * r + 1] = (unsigned char)((uop >> 8) & 0xFF);
    }
    o->wire.len += 7 * L;
    o->row_ret.len = o->row_slot.len = o->row_uop.len = 0;
    return 0;
}

/* Slots, interning and the return records (the Python scan's pass 2).
 * With stream set it also cuts segments of at least `target` returns
 * and writes their wire.  Returns 0, a REFUSE_ code with *at set, or -1
 * on error; publishes the interning on success only. */
static int scan_calls(const scan_in *in, PyObject *seen, PyObject *rows,
                      Py_ssize_t max_open_bits, int want_snaps, int stream,
                      long target, scan_out *o, Py_ssize_t *at) {
    Py_ssize_t cap = (max_open_bits < 0 ? 0
                      : max_open_bits < in->n ? max_open_bits : in->n) + 2;
    Py_ssize_t pid_cap = in->n_pid ? in->n_pid : 1;
    long *slot_of = PyMem_Malloc(pid_cap * sizeof(long));
    long *uop_of = PyMem_Malloc(pid_cap * sizeof(long));
    int32_t *open = PyMem_Malloc(cap * sizeof(int32_t));
    long *free_slots = PyMem_Malloc(cap * sizeof(long));
    long *pend_slot = PyMem_Malloc(cap * sizeof(long));
    long *pend_uop = PyMem_Malloc(cap * sizeof(long));
    PyObject *new_rows = PyList_New(0);
    utab ut = {0};
    int why = -1;
    if (!slot_of || !uop_of || !open || !free_slots || !pend_slot
        || !pend_uop) {
        PyErr_NoMemory();
        goto done;
    }
    if (!new_rows || utab_init(&ut) < 0) goto done;
    for (Py_ssize_t d = 0; d < in->n_pid; d++) slot_of[d] = -1;
    Py_ssize_t base_rows = PyList_GET_SIZE(rows);
    int seen_nonempty = PyDict_GET_SIZE(seen) > 0;
    long n_open = 0, n_free = 0, next_slot = 0, n_pend = 0;
    long nret_seg = 0, last_end = 0, last_cut = -1;
    Py_ssize_t rows_at_cut = 0;
    if (target < 1) target = 1;
    o->n_calls = o->max_open = o->n_rets = 0;

    for (Py_ssize_t i = 0; i < in->n; i++) {
        int32_t d = in->pid[i];
        if (d < 0) continue;
        int8_t t = in->kind[i];
        if (t == 0) {
            Py_ssize_t ci = in->fate[i];
            if (in->kind[ci] == 3) {
                *at = i;
                why = REFUSE_CRASHED;
                goto done;
            }
            if (in->kind[ci] == 2) continue;   /* a fail pair: dropped */
            long fc, a, b;
            int ok;
            int r = encode_call(in, i, ci, &fc, &a, &b, &ok, at);
            if (r != 0) {
                why = r;
                goto done;
            }
            long u = intern_uop(&ut, seen, seen_nonempty, base_rows,
                                new_rows, fc, a, b, ok);
            if (u < 0) goto done;
            long s = n_free ? free_slots[--n_free] : next_slot++;
            slot_of[d] = s;
            uop_of[d] = u;
            open[n_open++] = d;
            if (n_open > o->max_open) {
                o->max_open = n_open;
                if (n_open > max_open_bits) {
                    *at = i;
                    why = REFUSE_DEPTH;
                    goto done;
                }
            }
            o->n_calls++;
            pend_slot[n_pend] = s;
            pend_uop[n_pend] = u;
            n_pend++;
        } else if (t == 1) {
            long s = slot_of[d];
            if (s < 0) continue;               /* no open call: ignored */
            if (stream) {
                for (long j = 0; j + 1 < n_pend; j++)
                    if (put_row(o, -1, (int32_t)pend_slot[j],
                                (int32_t)pend_uop[j]) < 0)
                        goto done;
                if (put_row(o, (int32_t)s,
                            n_pend ? (int32_t)pend_slot[n_pend - 1] : -1,
                            n_pend ? (int32_t)pend_uop[n_pend - 1] : 0) < 0)
                    goto done;
            } else {
                if (push_i32(&o->rs, (int32_t)s) < 0
                    || push_i32(&o->counts, (int32_t)n_open) < 0
                    || push_i32(&o->dc, (int32_t)n_pend) < 0)
                    goto done;
                if (want_snaps)
                    for (long j = 0; j < n_open; j++)
                        if (push_i32(&o->cs, (int32_t)slot_of[open[j]]) < 0
                            || push_i32(&o->cu,
                                        (int32_t)uop_of[open[j]]) < 0)
                            goto done;
                for (long j = 0; j < n_pend; j++)
                    if (push_i32(&o->ds, (int32_t)pend_slot[j]) < 0
                        || push_i32(&o->du, (int32_t)pend_uop[j]) < 0)
                        goto done;
            }
            if (push_i32(&o->pos, (int32_t)i) < 0) goto done;
            n_pend = 0;
            long j = 0;
            while (open[j] != d) j++;          /* its first entry */
            memmove(open + j, open + j + 1,
                    (n_open - j - 1) * sizeof(int32_t));
            n_open--;
            slot_of[d] = -1;
            free_slots[n_free++] = s;
            o->n_rets++;
            if (!stream) {
                if (push_i32(&o->cuts, n_open == 0) < 0) goto done;
                continue;
            }
            nret_seg++;
            if (n_open == 0) {
                last_cut = o->n_rets - 1;
                rows_at_cut = o->row_ret.len / 4;
                if (nret_seg >= target) {
                    if (close_segment(o, rows_at_cut, o->n_rets) < 0)
                        goto done;
                    last_end = o->n_rets;
                    nret_seg = 0;
                }
            }
        }
    }
    /* the tail: up to the last quiescent return, as _segment_ends */
    if (stream && last_cut + 1 > last_end
        && close_segment(o, rows_at_cut, last_cut + 1) < 0)
        goto done;
    if (publish_interning(seen, rows, new_rows, base_rows) < 0) goto done;
    why = 0;
done:
    Py_XDECREF(new_rows);
    PyMem_Free(ut.e);
    PyMem_Free(slot_of);
    PyMem_Free(uop_of);
    PyMem_Free(open);
    PyMem_Free(free_slots);
    PyMem_Free(pend_slot);
    PyMem_Free(pend_uop);
    return why;
}

/* (reason, position) of a refusal, or NULL with the error set. */
static PyObject *refusal(int why, Py_ssize_t at) {
    if (why < 0) return NULL;
    return Py_BuildValue("(in)", why, at);
}

static PyObject *scan_result(const scan_out *o) {
    return Py_BuildValue(
        "(i(llNNNNNNNNN))", 0, o->n_calls, o->max_open, buf_bytes(&o->rs),
        buf_bytes(&o->counts), buf_bytes(&o->cs), buf_bytes(&o->cu),
        buf_bytes(&o->cuts), buf_bytes(&o->dc), buf_bytes(&o->ds),
        buf_bytes(&o->du), buf_bytes(&o->pos));
}

/* op.type as 0 invoke, 1 ok, 2 fail, 3 info, KIND_OTHER, or -1 on
 * error. */
static int op_kind(PyObject *op) {
    PyObject *t = PyObject_GetAttr(op, s_type);
    if (!t) return -1;
    int out = KIND_OTHER;
    for (int k = 0; k < 4; k++)
        if (t == t_names[k]) {
            out = k;
            break;
        }
    if (out == KIND_OTHER)
        for (int k = 0; k < 4; k++) {
            int r = PyObject_RichCompareBool(t, t_names[k], Py_EQ);
            if (r < 0) {
                Py_DECREF(t);
                return -1;
            }
            if (r) {
                out = k;
                break;
            }
        }
    Py_DECREF(t);
    return out;
}

/* Dense ids and kinds of the Op objects' client calls: an exact int
 * process >= 0 is a client (a bool or an int subclass is not). */
static int read_ops(scan_in *in) {
    htab ids = {0};
    PyObject *big = NULL;              /* ids of processes past int64 */
    int rc = -1;
    if (htab_init(&ids, 64) < 0) goto done;
    in->n_pid = 0;
    for (Py_ssize_t i = 0; i < in->n; i++) {
        PyObject *op = PyList_GET_ITEM(in->ops, i);
        in->pid[i] = -1;
        PyObject *p = PyObject_GetAttr(op, s_process);
        if (!p) goto done;
        if (!PyLong_CheckExact(p)) {
            Py_DECREF(p);
            continue;
        }
        int over = 0;
        long long v = PyLong_AsLongLongAndOverflow(p, &over);
        if (v == -1 && PyErr_Occurred()) {
            Py_DECREF(p);
            goto done;
        }
        long d;
        if (over < 0 || (!over && v < 0)) {
            Py_DECREF(p);
            continue;
        }
        if (over > 0) {
            if (!big && !(big = PyDict_New())) {
                Py_DECREF(p);
                goto done;
            }
            PyObject *id = PyDict_GetItemWithError(big, p);
            if (id) {
                d = PyLong_AsLong(id);
            } else if (PyErr_Occurred()) {
                Py_DECREF(p);
                goto done;
            } else {
                d = (long)in->n_pid;
                PyObject *dd = PyLong_FromLong(d);
                int r = dd ? PyDict_SetItem(big, p, dd) : -1;
                Py_XDECREF(dd);
                if (r < 0) {
                    Py_DECREF(p);
                    goto done;
                }
            }
        } else {
            d = htab_get_or_add(&ids, v, (long)in->n_pid);
            if (d < 0) {
                Py_DECREF(p);
                goto done;
            }
        }
        Py_DECREF(p);
        if (d == in->n_pid) in->n_pid++;
        int k = op_kind(op);
        if (k < 0) goto done;
        in->pid[i] = (int32_t)d;
        in->kind[i] = (int8_t)k;
    }
    rc = 0;
done:
    PyMem_Free(ids.e);
    Py_XDECREF(big);
    return rc;
}

/* Dense ids and kinds from the columns.  Returns 0, REFUSE_COLUMNS, or
 * -1 on error. */
static int read_cols(scan_in *in, const int32_t *proc, const uint8_t *typ) {
    htab ids = {0};
    if (htab_init(&ids, 64) < 0) return -1;
    in->n_pid = 0;
    int rc = 0;
    for (Py_ssize_t i = 0; i < in->n; i++) {
        int32_t p = proc[i];
        if (p == P_OUT_OF_RANGE) {
            rc = REFUSE_COLUMNS;
            break;
        }
        in->pid[i] = -1;
        if (p < 0) continue;
        long d = htab_get_or_add(&ids, p, (long)in->n_pid);
        if (d < 0) {
            rc = -1;
            break;
        }
        if (d == in->n_pid) in->n_pid++;
        in->pid[i] = (int32_t)d;
        in->kind[i] = typ[i] < 4 ? (int8_t)typ[i] : KIND_OTHER;
    }
    PyMem_Free(ids.e);
    return rc;
}

static PyObject *fast_scan(PyObject *Py_UNUSED(self), PyObject *args) {
    PyObject *ops, *f_codes, *seen, *rows;
    Py_ssize_t max_open_bits;
    if (!PyArg_ParseTuple(args, "O!O!O!O!n", &PyList_Type, &ops,
                          &PyDict_Type, &f_codes, &PyDict_Type, &seen,
                          &PyList_Type, &rows, &max_open_bits))
        return NULL;
    scan_in in = {0};
    scan_out o = {0};
    PyObject *res = NULL;
    Py_ssize_t at = -1;
    in.ops = ops;
    in.f_codes = f_codes;
    if (scan_in_alloc(&in, PyList_GET_SIZE(ops)) < 0 || read_ops(&in) < 0)
        goto done;
    int why = pair_calls(&in, &at);
    if (why == 0)
        why = scan_calls(&in, seen, rows, max_open_bits, 1, 0, 0, &o, &at);
    res = why == 0 ? scan_result(&o) : refusal(why, at);
done:
    scan_in_free(&in);
    scan_out_free(&o);
    return res;
}

/* The shared part of the two column entry points: the buffers' checks,
 * the columns' read and the pairing.  Returns 0 or a REFUSE_ code, or -1
 * with the error set. */
static int cols_in(scan_in *in, Py_buffer *bufs, Py_ssize_t *at) {
    Py_ssize_t n = bufs[0].len / 4;
    if (bufs[1].len != n || bufs[2].len / 4 != n || bufs[3].len / 4 != n
        || bufs[4].len / 4 != n || bufs[5].len != n) {
        PyErr_SetString(PyExc_ValueError, "column length mismatch");
        return -1;
    }
    if (scan_in_alloc(in, n) < 0) return -1;
    in->fmap = bufs[2].buf;
    in->va = bufs[3].buf;
    in->vb = bufs[4].buf;
    in->vk = bufs[5].buf;
    int why = read_cols(in, bufs[0].buf, bufs[1].buf);
    if (why != 0) return why;
    return pair_calls(in, at);
}

static void release(Py_buffer *bufs) {
    for (int k = 0; k < 6; k++)
        if (bufs[k].obj) PyBuffer_Release(&bufs[k]);
}

static PyObject *fast_scan_cols(PyObject *Py_UNUSED(self), PyObject *args) {
    Py_buffer bufs[6] = {{0}};
    PyObject *seen, *rows;
    Py_ssize_t max_open_bits;
    int want_snaps = 1;
    if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*O!O!n|i", &bufs[0], &bufs[1],
                          &bufs[2], &bufs[3], &bufs[4], &bufs[5],
                          &PyDict_Type, &seen, &PyList_Type, &rows,
                          &max_open_bits, &want_snaps))
        return NULL;
    scan_in in = {0};
    scan_out o = {0};
    Py_ssize_t at = -1;
    int why = cols_in(&in, bufs, &at);
    if (why == 0)
        why = scan_calls(&in, seen, rows, max_open_bits, want_snaps, 0, 0,
                         &o, &at);
    PyObject *res = why == 0 ? scan_result(&o) : refusal(why, at);
    scan_in_free(&in);
    scan_out_free(&o);
    release(bufs);
    return res;
}

static PyObject *fast_scan_streams(PyObject *Py_UNUSED(self), PyObject *args) {
    Py_buffer bufs[6] = {{0}};
    PyObject *seen, *rows;
    Py_ssize_t max_open_bits;
    long target;
    if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*O!O!nl", &bufs[0], &bufs[1],
                          &bufs[2], &bufs[3], &bufs[4], &bufs[5],
                          &PyDict_Type, &seen, &PyList_Type, &rows,
                          &max_open_bits, &target))
        return NULL;
    scan_in in = {0};
    scan_out o = {0};
    Py_ssize_t at = -1;
    int why = cols_in(&in, bufs, &at);
    if (why == 0)
        why = scan_calls(&in, seen, rows, max_open_bits, 0, 1, target, &o,
                         &at);
    PyObject *res = why == 0
        ? Py_BuildValue("(i(lllNNNNN))", 0, o.n_calls, o.max_open,
                        o.n_rets, buf_bytes(&o.wire), buf_bytes(&o.offs),
                        buf_bytes(&o.nrows), buf_bytes(&o.seg_ends),
                        buf_bytes(&o.pos))
        : refusal(why, at);
    scan_in_free(&in);
    scan_out_free(&o);
    release(bufs);
    return res;
}

static PyMethodDef methods[] = {
    {"fast_scan", fast_scan, METH_VARARGS,
     "The scan over a list of Op objects."},
    {"fast_scan_cols", fast_scan_cols, METH_VARARGS,
     "The scan over a history's columns."},
    {"fast_scan_streams", fast_scan_streams, METH_VARARGS,
     "The column scan with its segments and their wire."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_histscan", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit__histscan(void) {
    const char *names[4] = {"invoke", "ok", "fail", "info"};
    s_process = PyUnicode_InternFromString("process");
    s_type = PyUnicode_InternFromString("type");
    s_f = PyUnicode_InternFromString("f");
    s_value = PyUnicode_InternFromString("value");
    if (!s_process || !s_type || !s_f || !s_value) return NULL;
    for (int k = 0; k < 4; k++)
        if (!(t_names[k] = PyUnicode_InternFromString(names[k])))
            return NULL;
    return PyModule_Create(&moduledef);
}
