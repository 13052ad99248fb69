// PNG scanline unfiltering for the port's PNG decoder
// (orb_slam_tpu_torch/dataio/png.py).
//
// A non-interlaced PNG image is a sequence of rows, each one filter-type
// byte followed by `stride` filtered bytes (PNG spec section 9).  Filters
// 1 (Sub), 3 (Average) and 4 (Paeth) read the reconstructed byte `bpp`
// bytes to the left, so a row is a serial recurrence: a byte loop here
// instead of a Python one.
//
//   unfilter(src, dst, height, stride, bpp)
//     src  height * (1 + stride) bytes (the inflated IDAT stream)
//     dst  writable height * stride bytes, the reconstructed rows
//   raises ValueError on a filter type outside 0-4 or short buffers.
//
// Built as a plain C extension by g++ (_build.build_host_extension); the
// buffers are read through the buffer protocol, with the GIL released
// around the byte loop.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

// Returns -1 on success, else the index of the first row whose filter
// type is not 0-4.
Py_ssize_t unfilter_rows(const uint8_t* src, uint8_t* dst, Py_ssize_t height,
                         Py_ssize_t stride, Py_ssize_t bpp) {
    for (Py_ssize_t y = 0; y < height; ++y) {
        const uint8_t ft = src[y * (stride + 1)];
        const uint8_t* f = src + y * (stride + 1) + 1;
        uint8_t* x = dst + y * stride;
        const uint8_t* b = y ? x - stride : nullptr;   // prior row
        switch (ft) {
            case 0:
                for (Py_ssize_t i = 0; i < stride; ++i) x[i] = f[i];
                break;
            case 1:
                for (Py_ssize_t i = 0; i < stride; ++i)
                    x[i] = f[i] + (i >= bpp ? x[i - bpp] : 0);
                break;
            case 2:
                for (Py_ssize_t i = 0; i < stride; ++i)
                    x[i] = f[i] + (b ? b[i] : 0);
                break;
            case 3:
                for (Py_ssize_t i = 0; i < stride; ++i) {
                    int a = i >= bpp ? x[i - bpp] : 0;
                    int up = b ? b[i] : 0;
                    x[i] = f[i] + static_cast<uint8_t>((a + up) >> 1);
                }
                break;
            case 4:
                for (Py_ssize_t i = 0; i < stride; ++i) {
                    int a = i >= bpp ? x[i - bpp] : 0;
                    int up = b ? b[i] : 0;
                    int c = (b && i >= bpp) ? b[i - bpp] : 0;
                    x[i] = f[i] + paeth(a, up, c);
                }
                break;
            default:
                return y;
        }
    }
    return -1;
}

PyObject* unfilter(PyObject*, PyObject* args) {
    PyObject *src_o, *dst_o;
    Py_ssize_t height, stride, bpp;
    if (!PyArg_ParseTuple(args, "OOnnn", &src_o, &dst_o, &height, &stride,
                          &bpp))
        return nullptr;
    if (height < 0 || stride < 1 || bpp < 1 || bpp > 8) {
        PyErr_Format(PyExc_ValueError,
                     "unfilter: bad geometry height=%zd stride=%zd bpp=%zd",
                     height, stride, bpp);
        return nullptr;
    }
    Py_buffer src, dst;
    if (PyObject_GetBuffer(src_o, &src, PyBUF_C_CONTIGUOUS) != 0)
        return nullptr;
    if (PyObject_GetBuffer(dst_o, &dst, PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE)
        != 0) {
        PyBuffer_Release(&src);
        return nullptr;
    }
    PyObject* result = nullptr;
    if (src.len < height * (stride + 1) || dst.len < height * stride) {
        PyErr_Format(PyExc_ValueError,
                     "unfilter: %zd source bytes and %zd destination bytes "
                     "for %zd rows of %zd bytes",
                     src.len, dst.len, height, stride);
    } else {
        Py_ssize_t bad;
        Py_BEGIN_ALLOW_THREADS
        bad = unfilter_rows(static_cast<const uint8_t*>(src.buf),
                            static_cast<uint8_t*>(dst.buf), height, stride,
                            bpp);
        Py_END_ALLOW_THREADS
        if (bad >= 0) {
            PyErr_Format(PyExc_ValueError,
                         "PNG row %zd: filter type %d is not one of 0-4", bad,
                         static_cast<const uint8_t*>(src.buf)[bad * (stride + 1)]);
        } else {
            Py_INCREF(Py_None);
            result = Py_None;
        }
    }
    PyBuffer_Release(&dst);
    PyBuffer_Release(&src);
    return result;
}

PyMethodDef methods[] = {
    {"unfilter", unfilter, METH_VARARGS,
     "Reconstruct filtered PNG scanlines into a writable buffer."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_png_unfilter",
    "PNG scanline unfiltering for orb_slam_tpu_torch", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__png_unfilter(void) { return PyModule_Create(&module); }
