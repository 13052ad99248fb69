// Native host-side graph bookkeeping for the SoA map.
//
// The reference keeps its observation graph in per-object std::map /
// std::set structures maintained by C++ methods (KeyFrame::UpdateConnections
// src/KeyFrame.cc:332-421, MapPoint::Replace src/MapPoint.cc:124-158,
// Optimizer edge assembly src/Optimizer.cc:287-430).  In this engine the
// device holds SoA arrays and the *host* performs the irregular, branchy
// graph maintenance between kernels.  These are the per-keyframe hot host
// paths, implemented natively:
//
//   pack_ba_edges      edge-list packing for bundle-adjustment problems
//   remap_observations landmark-merge remap with per-row duplicate removal
//   vote_keyframes     local-keyframe voting from tracked landmark ids
//
// Built as a plain C extension (no pybind11 in this environment); NumPy
// arrays are accessed through the buffer protocol to avoid a compile-time
// NumPy header dependency.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BufferView {
    Py_buffer view{};
    bool ok = false;
    ~BufferView() { if (ok) PyBuffer_Release(&view); }
    bool acquire(PyObject* obj, const char* name, const char* fmt_expect,
                 int ndim_expect) {
        if (PyObject_GetBuffer(obj, &view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT)
            != 0) {
            return false;
        }
        ok = true;
        if (view.ndim != ndim_expect) {
            PyErr_Format(PyExc_ValueError, "%s: expected %d dims, got %d",
                         name, ndim_expect, view.ndim);
            return false;
        }
        if (fmt_expect && view.format &&
            std::strcmp(view.format, fmt_expect) != 0) {
            PyErr_Format(PyExc_ValueError, "%s: expected format %s, got %s",
                         name, fmt_expect, view.format);
            return false;
        }
        return true;
    }
};

// pack_ba_edges(obs [C, N] int32, kp_valid [C, N] uint8, lut [P1] int32)
//   -> (cam_idx [C*N] int32, pt_idx [C*N] int32, slot_idx [C*N] int32,
//       valid [C*N] uint8)
PyObject* pack_ba_edges(PyObject*, PyObject* args) {
    PyObject *obs_o, *kpv_o, *lut_o;
    if (!PyArg_ParseTuple(args, "OOO", &obs_o, &kpv_o, &lut_o)) return nullptr;
    BufferView obs, kpv, lut;
    if (!obs.acquire(obs_o, "obs", "i", 2)) return nullptr;
    if (!kpv.acquire(kpv_o, "kp_valid", "B", 2)) return nullptr;
    if (!lut.acquire(lut_o, "lut", "i", 1)) return nullptr;

    const Py_ssize_t C = obs.view.shape[0];
    const Py_ssize_t N = obs.view.shape[1];
    const Py_ssize_t P1 = lut.view.shape[0];
    const int32_t* obs_p = static_cast<const int32_t*>(obs.view.buf);
    const uint8_t* kpv_p = static_cast<const uint8_t*>(kpv.view.buf);
    const int32_t* lut_p = static_cast<const int32_t*>(lut.view.buf);

    const Py_ssize_t total = C * N;
    PyObject* cam_b = PyByteArray_FromStringAndSize(nullptr, total * 4);
    PyObject* pt_b = PyByteArray_FromStringAndSize(nullptr, total * 4);
    PyObject* slot_b = PyByteArray_FromStringAndSize(nullptr, total * 4);
    PyObject* val_b = PyByteArray_FromStringAndSize(nullptr, total);
    if (!cam_b || !pt_b || !slot_b || !val_b) return nullptr;
    int32_t* cam_p = reinterpret_cast<int32_t*>(PyByteArray_AS_STRING(cam_b));
    int32_t* pt_p = reinterpret_cast<int32_t*>(PyByteArray_AS_STRING(pt_b));
    int32_t* slot_p = reinterpret_cast<int32_t*>(PyByteArray_AS_STRING(slot_b));
    uint8_t* val_p = reinterpret_cast<uint8_t*>(PyByteArray_AS_STRING(val_b));

    Py_ssize_t o = 0;
    for (Py_ssize_t c = 0; c < C; ++c) {
        for (Py_ssize_t n = 0; n < N; ++n, ++o) {
            const int32_t pid = obs_p[o];
            int32_t local = -1;
            if (pid >= 0 && pid < P1 && kpv_p[o]) local = lut_p[pid];
            cam_p[o] = static_cast<int32_t>(c);
            slot_p[o] = static_cast<int32_t>(n);
            pt_p[o] = local >= 0 ? local : 0;
            val_p[o] = local >= 0 ? 1 : 0;
        }
    }
    return Py_BuildValue("NNNN", cam_b, pt_b, slot_b, val_b);
}

// remap_observations(obs [K, N] int32 (modified in place), lut [P1] int32)
//   -> int  (number of entries changed)
// Applies landmark-merge lookups and clears duplicate landmark ids within a
// row (a keyframe must not observe the same landmark twice).
PyObject* remap_observations(PyObject*, PyObject* args) {
    PyObject *obs_o, *lut_o;
    if (!PyArg_ParseTuple(args, "OO", &obs_o, &lut_o)) return nullptr;
    Py_buffer obs;
    if (PyObject_GetBuffer(obs_o, &obs,
                           PyBUF_C_CONTIGUOUS | PyBUF_FORMAT | PyBUF_WRITABLE)
        != 0) {
        return nullptr;
    }
    BufferView lut;
    if (!lut.acquire(lut_o, "lut", "i", 1)) { PyBuffer_Release(&obs); return nullptr; }
    const Py_ssize_t K = obs.shape[0];
    const Py_ssize_t N = obs.shape[1];
    const Py_ssize_t P1 = lut.view.shape[0];
    int32_t* obs_p = static_cast<int32_t*>(obs.buf);
    const int32_t* lut_p = static_cast<const int32_t*>(lut.view.buf);

    std::vector<int32_t> seen_stamp(static_cast<size_t>(P1), -1);
    long changed = 0;
    for (Py_ssize_t k = 0; k < K; ++k) {
        int32_t* row = obs_p + k * N;
        for (Py_ssize_t n = 0; n < N; ++n) {
            int32_t pid = row[n];
            if (pid < 0) continue;
            int32_t mapped = (pid < P1) ? lut_p[pid] : pid;
            if (mapped != pid) { row[n] = mapped; ++changed; pid = mapped; }
            if (pid < 0) continue;
            if (pid < P1) {
                if (seen_stamp[pid] == static_cast<int32_t>(k)) {
                    row[n] = -1;  // duplicate within this keyframe
                    ++changed;
                } else {
                    seen_stamp[pid] = static_cast<int32_t>(k);
                }
            }
        }
    }
    PyBuffer_Release(&obs);
    return PyLong_FromLong(changed);
}

// vote_keyframes(obs [K, N] int32, seed [P1] uint8) -> votes bytearray int32[K]
PyObject* vote_keyframes(PyObject*, PyObject* args) {
    PyObject *obs_o, *seed_o;
    if (!PyArg_ParseTuple(args, "OO", &obs_o, &seed_o)) return nullptr;
    BufferView obs, seed;
    if (!obs.acquire(obs_o, "obs", "i", 2)) return nullptr;
    if (!seed.acquire(seed_o, "seed", "B", 1)) return nullptr;
    const Py_ssize_t K = obs.view.shape[0];
    const Py_ssize_t N = obs.view.shape[1];
    const Py_ssize_t P1 = seed.view.shape[0];
    const int32_t* obs_p = static_cast<const int32_t*>(obs.view.buf);
    const uint8_t* seed_p = static_cast<const uint8_t*>(seed.view.buf);

    PyObject* out = PyByteArray_FromStringAndSize(nullptr, K * 4);
    if (!out) return nullptr;
    int32_t* out_p = reinterpret_cast<int32_t*>(PyByteArray_AS_STRING(out));
    for (Py_ssize_t k = 0; k < K; ++k) {
        int32_t v = 0;
        const int32_t* row = obs_p + k * N;
        for (Py_ssize_t n = 0; n < N; ++n) {
            const int32_t pid = row[n];
            if (pid >= 0 && pid < P1 && seed_p[pid]) ++v;
        }
        out_p[k] = v;
    }
    return out;
}

// covisibility_counts(obs [K, N] int32, kf_valid [K] uint8, n_points int)
//   -> W bytearray int32[K*K]
// Sparse shared-observation counting via a point->keyframe CSR walk:
// O(total_obs + sum_p deg(p)^2), replacing the dense [K, P] incidence
// product (KeyFrame::UpdateConnections counting, src/KeyFrame.cc:332-377,
// done for ALL keyframes at once).  Diagonal is zeroed.
PyObject* covisibility_counts(PyObject*, PyObject* args) {
    PyObject *obs_o, *kfv_o;
    long n_points;
    if (!PyArg_ParseTuple(args, "OOl", &obs_o, &kfv_o, &n_points))
        return nullptr;
    BufferView obs, kfv;
    if (!obs.acquire(obs_o, "obs", "i", 2)) return nullptr;
    if (!kfv.acquire(kfv_o, "kf_valid", "B", 1)) return nullptr;
    const Py_ssize_t K = obs.view.shape[0];
    const Py_ssize_t N = obs.view.shape[1];
    const int32_t* obs_p = static_cast<const int32_t*>(obs.view.buf);
    const uint8_t* kfv_p = static_cast<const uint8_t*>(kfv.view.buf);

    // CSR: per-point keyframe lists (duplicates within a row are the
    // caller's invariant — remap_observations dedups)
    std::vector<int32_t> deg(static_cast<size_t>(n_points) + 1, 0);
    for (Py_ssize_t k = 0; k < K; ++k) {
        if (!kfv_p[k]) continue;
        const int32_t* row = obs_p + k * N;
        for (Py_ssize_t n = 0; n < N; ++n) {
            const int32_t pid = row[n];
            if (pid >= 0 && pid < n_points) ++deg[pid];
        }
    }
    std::vector<int64_t> off(static_cast<size_t>(n_points) + 1, 0);
    for (long p = 0; p < n_points; ++p) off[p + 1] = off[p] + deg[p];
    std::vector<int32_t> pkf(static_cast<size_t>(off[n_points]));
    std::vector<int64_t> cur(off.begin(), off.end() - 1);
    for (Py_ssize_t k = 0; k < K; ++k) {
        if (!kfv_p[k]) continue;
        const int32_t* row = obs_p + k * N;
        for (Py_ssize_t n = 0; n < N; ++n) {
            const int32_t pid = row[n];
            if (pid >= 0 && pid < n_points)
                pkf[cur[pid]++] = static_cast<int32_t>(k);
        }
    }

    PyObject* out = PyByteArray_FromStringAndSize(nullptr, K * K * 4);
    if (!out) return nullptr;
    int32_t* W = reinterpret_cast<int32_t*>(PyByteArray_AS_STRING(out));
    std::memset(W, 0, static_cast<size_t>(K) * K * 4);
    for (long p = 0; p < n_points; ++p) {
        const int64_t a = off[p], b = off[p + 1];
        for (int64_t i = a; i < b; ++i) {
            const int32_t ki = pkf[i];
            int32_t* Wi = W + static_cast<int64_t>(ki) * K;
            for (int64_t j = i + 1; j < b; ++j) {
                const int32_t kj = pkf[j];
                ++Wi[kj];
                ++W[static_cast<int64_t>(kj) * K + ki];
            }
        }
    }
    return out;
}

PyMethodDef methods[] = {
    {"pack_ba_edges", pack_ba_edges, METH_VARARGS,
     "Pack SoA observations into BA edge arrays."},
    {"remap_observations", remap_observations, METH_VARARGS,
     "Apply landmark-merge lut to obs in place; dedup per keyframe row."},
    {"vote_keyframes", vote_keyframes, METH_VARARGS,
     "Count seed-landmark observations per keyframe."},
    {"covisibility_counts", covisibility_counts, METH_VARARGS,
     "Sparse [K, K] shared-observation counts from SoA observations."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_graphops",
    "Native host graph ops for orb_slam_tpu", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__graphops(void) { return PyModule_Create(&module); }
