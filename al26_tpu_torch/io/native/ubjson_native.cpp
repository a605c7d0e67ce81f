// UBJSON (Draft-12) codec — C++ accelerator for al26_tpu_torch.io.ubjson.
//
// The port's own copy of the JAX package's native codec
// (al26_tpu/io/native/ubjson_native.cpp), with the same wire format; only
// the module's name differs (_ubjson_native_torch), so that both builds
// can live in one process.
//
// The reference leans on the py-ubjson C extension for its checkpoint
// serialisation speed (al26_nbody.py:41, 250-252: ~25x faster than pickle).
// This module provides the same native-speed path: dumpb(obj) /
// loadb(bytes) with the exact wire semantics of the pure-Python codec in
// al26_tpu_torch/io/ubjson.py (the behavioural specification):
//   * encoder: None/bool/int/float/str/bytes/list/tuple/dict; homogeneous
//     float lists emit optimized typed arrays ([$D#) with big-endian
//     payloads written straight from PyFloat values;
//   * decoder: full Draft-12 including optimized containers and all
//     numeric widths.
//
// Built at first use by al26_tpu_torch/io/native_build.py (CPython C API
// only, no third-party headers).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <exception>
#include <new>
#include <string>

// ---------------------------------------------------------------------------
// byte-order helpers (UBJSON is big-endian)
// ---------------------------------------------------------------------------
static inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
static inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
static inline uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

static inline bool is_little_endian() {
    const uint16_t x = 1;
    return *reinterpret_cast<const uint8_t*>(&x) == 1;
}

// ---------------------------------------------------------------------------
// encoder
// ---------------------------------------------------------------------------
// recursion bound: deeper nesting must raise, not overflow the C stack
static const int kMaxDepth = 2000;

struct Encoder {
    std::string buf;
    int depth = 0;

    void put(char c) { buf.push_back(c); }
    void put_raw(const void* p, size_t n) {
        buf.append(reinterpret_cast<const char*>(p), n);
    }

    void put_u16(uint16_t v) { if (is_little_endian()) v = bswap16(v); put_raw(&v, 2); }
    void put_u32(uint32_t v) { if (is_little_endian()) v = bswap32(v); put_raw(&v, 4); }
    void put_u64(uint64_t v) { if (is_little_endian()) v = bswap64(v); put_raw(&v, 8); }

    void put_int(long long v) {
        if (v >= -128 && v <= 127) {
            put('i');
            put(static_cast<char>(static_cast<int8_t>(v)));
        } else if (v >= 0 && v <= 255) {
            put('U');
            put(static_cast<char>(static_cast<uint8_t>(v)));
        } else if (v >= -32768 && v <= 32767) {
            put('I');
            put_u16(static_cast<uint16_t>(static_cast<int16_t>(v)));
        } else if (v >= -2147483648LL && v <= 2147483647LL) {
            put('l');
            put_u32(static_cast<uint32_t>(static_cast<int32_t>(v)));
        } else {
            put('L');
            put_u64(static_cast<uint64_t>(v));
        }
    }

    void put_double(double d) {
        put('D');
        uint64_t bits;
        std::memcpy(&bits, &d, 8);
        put_u64(bits);  // put_u64 performs the big-endian swap
    }

    // returns 0 on success, -1 with a Python exception set (e.g. a lone
    // surrogate that cannot encode to UTF-8)
    int put_str_body(PyObject* s) {
        Py_ssize_t n = 0;
        const char* data = PyUnicode_AsUTF8AndSize(s, &n);
        if (data == nullptr) return -1;
        put_int(static_cast<long long>(n));
        put_raw(data, static_cast<size_t>(n));
        return 0;
    }

    // returns 0 on success, -1 with a Python exception set on failure
    int encode(PyObject* obj) {
        if (depth >= kMaxDepth) {
            PyErr_SetString(PyExc_RecursionError,
                            "UBJSON nesting too deep");
            return -1;
        }
        if (obj == Py_None) { put('Z'); return 0; }
        if (obj == Py_True) { put('T'); return 0; }
        if (obj == Py_False) { put('F'); return 0; }
        if (PyFloat_Check(obj)) {
            put_double(PyFloat_AS_DOUBLE(obj));
            return 0;
        }
        if (PyLong_CheckExact(obj)) {
            int overflow = 0;
            long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
            if (!overflow) { put_int(v); return 0; }
            // out of int64 range: high-precision number (decimal string)
            PyObject* s = PyObject_Str(obj);
            if (!s) return -1;
            put('H');
            int rc = put_str_body(s);
            Py_DECREF(s);
            return rc;
        }
        if (PyUnicode_CheckExact(obj)) {
            put('S');
            return put_str_body(obj);
        }
        if (PyBytes_CheckExact(obj) || PyByteArray_CheckExact(obj)) {
            char* data;
            Py_ssize_t n;
            if (PyBytes_CheckExact(obj)) {
                PyBytes_AsStringAndSize(obj, &data, &n);
            } else {
                data = PyByteArray_AS_STRING(obj);
                n = PyByteArray_GET_SIZE(obj);
            }
            buf.append("[$U#", 4);
            put_int(static_cast<long long>(n));
            put_raw(data, static_cast<size_t>(n));
            return 0;
        }
        if (PyList_CheckExact(obj) || PyTuple_CheckExact(obj)) {
            Py_ssize_t n = PySequence_Fast_GET_SIZE(obj);
            PyObject** items = PySequence_Fast_ITEMS(obj);
            // fast path: homogeneous float list -> typed array
            bool all_float = n > 0;
            for (Py_ssize_t i = 0; i < n; i++) {
                if (!PyFloat_Check(items[i])) { all_float = false; break; }
            }
            if (all_float) {
                buf.append("[$D#", 4);
                put_int(static_cast<long long>(n));
                size_t off = buf.size();
                buf.resize(off + 8 * static_cast<size_t>(n));
                char* out = &buf[off];
                for (Py_ssize_t i = 0; i < n; i++) {
                    double d = PyFloat_AS_DOUBLE(items[i]);
                    uint64_t bits;
                    std::memcpy(&bits, &d, 8);
                    if (is_little_endian()) bits = bswap64(bits);
                    std::memcpy(out + 8 * i, &bits, 8);
                }
                return 0;
            }
            put('[');
            depth++;
            for (Py_ssize_t i = 0; i < n; i++) {
                if (encode(items[i]) < 0) return -1;
            }
            depth--;
            put(']');
            return 0;
        }
        if (PyDict_CheckExact(obj)) {
            put('{');
            PyObject *key, *value;
            Py_ssize_t pos = 0;
            while (PyDict_Next(obj, &pos, &key, &value)) {
                if (!PyUnicode_CheckExact(key)) {
                    PyErr_SetString(PyExc_TypeError,
                                    "UBJSON object keys must be str");
                    return -1;
                }
                if (put_str_body(key) < 0) return -1;
                depth++;
                if (encode(value) < 0) return -1;
                depth--;
            }
            put('}');
            return 0;
        }
        PyErr_Format(PyExc_TypeError, "cannot UBJSON-encode %s",
                     Py_TYPE(obj)->tp_name);
        return -1;
    }
};

// ---------------------------------------------------------------------------
// decoder
// ---------------------------------------------------------------------------
struct Decoder {
    const uint8_t* p;
    const uint8_t* end;
    int depth = 0;

    bool need(size_t n) {
        if (static_cast<size_t>(end - p) < n) {
            PyErr_SetString(PyExc_ValueError, "truncated UBJSON input");
            return false;
        }
        return true;
    }

    int marker() {
        while (true) {
            if (!need(1)) return -1;
            uint8_t m = *p++;
            if (m != 'N') return m;
        }
    }

    bool read_u16(uint16_t* v) { if (!need(2)) return false; std::memcpy(v, p, 2); p += 2; if (is_little_endian()) *v = bswap16(*v); return true; }
    bool read_u32(uint32_t* v) { if (!need(4)) return false; std::memcpy(v, p, 4); p += 4; if (is_little_endian()) *v = bswap32(*v); return true; }
    bool read_u64(uint64_t* v) { if (!need(8)) return false; std::memcpy(v, p, 8); p += 8; if (is_little_endian()) *v = bswap64(*v); return true; }

    // numeric value for marker m into ll; false on error
    bool read_int(int m, long long* out) {
        switch (m) {
            case 'i': { if (!need(1)) return false; *out = static_cast<int8_t>(*p++); return true; }
            case 'U': { if (!need(1)) return false; *out = *p++; return true; }
            case 'I': { uint16_t v; if (!read_u16(&v)) return false; *out = static_cast<int16_t>(v); return true; }
            case 'l': { uint32_t v; if (!read_u32(&v)) return false; *out = static_cast<int32_t>(v); return true; }
            case 'L': { uint64_t v; if (!read_u64(&v)) return false; *out = static_cast<int64_t>(v); return true; }
            default:
                PyErr_Format(PyExc_ValueError, "invalid length marker '%c'", m);
                return false;
        }
    }

    bool read_length(Py_ssize_t* out) {
        int m = marker();
        if (m < 0) return false;
        long long v;
        if (!read_int(m, &v)) return false;
        if (v < 0) {
            PyErr_SetString(PyExc_ValueError, "negative container length");
            return false;
        }
        *out = static_cast<Py_ssize_t>(v);
        return true;
    }

    PyObject* read_str_body() {
        Py_ssize_t n;
        if (!read_length(&n)) return nullptr;
        if (!need(static_cast<size_t>(n))) return nullptr;
        PyObject* s = PyUnicode_DecodeUTF8(
            reinterpret_cast<const char*>(p), n, nullptr);
        p += n;
        return s;
    }

    PyObject* decode_value(int m) {
        if (depth >= kMaxDepth) {
            PyErr_SetString(PyExc_ValueError,
                            "UBJSON nesting too deep");
            return nullptr;
        }
        switch (m) {
            case 'Z': Py_RETURN_NONE;
            case 'T': Py_RETURN_TRUE;
            case 'F': Py_RETURN_FALSE;
            case 'i': case 'U': case 'I': case 'l': case 'L': {
                long long v;
                if (!read_int(m, &v)) return nullptr;
                return PyLong_FromLongLong(v);
            }
            case 'd': {
                uint32_t bits;
                if (!read_u32(&bits)) return nullptr;
                float f;
                std::memcpy(&f, &bits, 4);
                return PyFloat_FromDouble(static_cast<double>(f));
            }
            case 'D': {
                uint64_t bits;
                if (!read_u64(&bits)) return nullptr;
                double d;
                std::memcpy(&d, &bits, 8);
                return PyFloat_FromDouble(d);
            }
            case 'C': {
                if (!need(1)) return nullptr;
                char c = static_cast<char>(*p++);
                return PyUnicode_DecodeLatin1(&c, 1, nullptr);
            }
            case 'S': return read_str_body();
            case 'H': {
                PyObject* s = read_str_body();
                if (!s) return nullptr;
                PyObject* v = PyLong_FromUnicodeObject(s, 10);
                if (!v) {
                    PyErr_Clear();
                    v = PyFloat_FromString(s);
                }
                Py_DECREF(s);
                return v;
            }
            case '[': {
                depth++;
                PyObject* out = decode_array();
                depth--;
                return out;
            }
            case '{': {
                depth++;
                PyObject* out = decode_object();
                depth--;
                return out;
            }
        }
        PyErr_Format(PyExc_ValueError, "invalid UBJSON marker 0x%02x", m);
        return nullptr;
    }

    PyObject* decode_typed_items(int typ, Py_ssize_t count) {
        // [$U# payloads decode as BYTES — py-ubjson's default semantics
        // (no_bytes=False), and the encoders here write Python bytes in
        // exactly this form (matches the pure-Python decoder)
        if (typ == 'U') {
            if (!need(static_cast<size_t>(count))) return nullptr;
            PyObject* b = PyBytes_FromStringAndSize(
                reinterpret_cast<const char*>(p), count);
            p += count;
            return b;
        }
        // fast path for float64 typed arrays (the bulk of yields files)
        if (typ == 'D') {
            if (!need(8 * static_cast<size_t>(count))) return nullptr;
            PyObject* list = PyList_New(count);
            if (!list) return nullptr;
            for (Py_ssize_t i = 0; i < count; i++) {
                uint64_t bits;
                std::memcpy(&bits, p + 8 * i, 8);
                if (is_little_endian()) bits = bswap64(bits);
                double d;
                std::memcpy(&d, &bits, 8);
                PyObject* f = PyFloat_FromDouble(d);
                if (!f) { Py_DECREF(list); return nullptr; }
                PyList_SET_ITEM(list, i, f);
            }
            p += 8 * static_cast<size_t>(count);
            return list;
        }
        if (typ == 'T' || typ == 'F' || typ == 'Z') {
            PyObject* v = typ == 'T' ? Py_True : (typ == 'F' ? Py_False : Py_None);
            PyObject* list = PyList_New(count);
            if (!list) return nullptr;
            for (Py_ssize_t i = 0; i < count; i++) {
                Py_INCREF(v);
                PyList_SET_ITEM(list, i, v);
            }
            return list;
        }
        PyObject* list = PyList_New(count);
        if (!list) return nullptr;
        for (Py_ssize_t i = 0; i < count; i++) {
            PyObject* v = decode_value(typ);
            if (!v) { Py_DECREF(list); return nullptr; }
            PyList_SET_ITEM(list, i, v);
        }
        return list;
    }

    PyObject* decode_array() {
        int m = marker();
        if (m < 0) return nullptr;
        int typ = -1;
        Py_ssize_t count = -1;
        if (m == '$') {
            if (!need(1)) return nullptr;
            typ = *p++;
            m = marker();
            if (m != '#') {
                PyErr_SetString(PyExc_ValueError,
                                "typed array requires a count");
                return nullptr;
            }
            if (!read_length(&count)) return nullptr;
            return decode_typed_items(typ, count);
        }
        if (m == '#') {
            if (!read_length(&count)) return nullptr;
            PyObject* list = PyList_New(count);
            if (!list) return nullptr;
            for (Py_ssize_t i = 0; i < count; i++) {
                int mi = marker();
                if (mi < 0) { Py_DECREF(list); return nullptr; }
                PyObject* v = decode_value(mi);
                if (!v) { Py_DECREF(list); return nullptr; }
                PyList_SET_ITEM(list, i, v);
            }
            return list;
        }
        PyObject* list = PyList_New(0);
        if (!list) return nullptr;
        while (true) {
            if (m == ']') return list;
            PyObject* v = decode_value(m);
            if (!v) { Py_DECREF(list); return nullptr; }
            int rc = PyList_Append(list, v);
            Py_DECREF(v);
            if (rc < 0) { Py_DECREF(list); return nullptr; }
            m = marker();
            if (m < 0) { Py_DECREF(list); return nullptr; }
        }
    }

    PyObject* decode_object() {
        int m = marker();
        if (m < 0) return nullptr;
        int typ = -1;
        Py_ssize_t count = -1;
        if (m == '$') {
            if (!need(1)) return nullptr;
            typ = *p++;
            m = marker();
            if (m != '#') {
                PyErr_SetString(PyExc_ValueError,
                                "typed object requires a count");
                return nullptr;
            }
            if (!read_length(&count)) return nullptr;
        } else if (m == '#') {
            if (!read_length(&count)) return nullptr;
            m = -2;
        }
        PyObject* dict = PyDict_New();
        if (!dict) return nullptr;
        if (count >= 0) {
            for (Py_ssize_t i = 0; i < count; i++) {
                PyObject* key = read_str_body();
                if (!key) { Py_DECREF(dict); return nullptr; }
                int mv = typ >= 0 ? typ : marker();
                if (mv < 0) { Py_DECREF(key); Py_DECREF(dict); return nullptr; }
                PyObject* v = decode_value(mv);
                if (!v) { Py_DECREF(key); Py_DECREF(dict); return nullptr; }
                int rc = PyDict_SetItem(dict, key, v);
                Py_DECREF(key);
                Py_DECREF(v);
                if (rc < 0) { Py_DECREF(dict); return nullptr; }
            }
            return dict;
        }
        while (true) {
            if (m == '}') return dict;
            // m is the first byte of the key's length marker
            p -= 1;
            PyObject* key = read_str_body();
            if (!key) { Py_DECREF(dict); return nullptr; }
            int mv = marker();
            if (mv < 0) { Py_DECREF(key); Py_DECREF(dict); return nullptr; }
            PyObject* v = decode_value(mv);
            if (!v) { Py_DECREF(key); Py_DECREF(dict); return nullptr; }
            int rc = PyDict_SetItem(dict, key, v);
            Py_DECREF(key);
            Py_DECREF(v);
            if (rc < 0) { Py_DECREF(dict); return nullptr; }
            m = marker();
            if (m < 0) { Py_DECREF(dict); return nullptr; }
        }
    }
};

// ---------------------------------------------------------------------------
// module functions
// ---------------------------------------------------------------------------
static PyObject* py_dumpb(PyObject*, PyObject* obj) {
    try {
        Encoder enc;
        enc.buf.reserve(1 << 12);
        if (enc.encode(obj) < 0) return nullptr;
        return PyBytes_FromStringAndSize(
            enc.buf.data(), static_cast<Py_ssize_t>(enc.buf.size()));
    } catch (const std::bad_alloc&) {
        return PyErr_NoMemory();
    } catch (const std::exception& e) {
        PyErr_SetString(PyExc_RuntimeError, e.what());
        return nullptr;
    }
}

static PyObject* py_loadb(PyObject*, PyObject* obj) {
    Py_buffer view;
    if (PyObject_GetBuffer(obj, &view, PyBUF_SIMPLE) < 0) return nullptr;
    PyObject* out = nullptr;
    try {
        Decoder dec;
        dec.p = static_cast<const uint8_t*>(view.buf);
        dec.end = dec.p + view.len;
        int m = dec.marker();
        out = m < 0 ? nullptr : dec.decode_value(m);
    } catch (const std::bad_alloc&) {
        PyErr_NoMemory();
    } catch (const std::exception& e) {
        PyErr_SetString(PyExc_RuntimeError, e.what());
    }
    PyBuffer_Release(&view);
    return out;
}

static PyMethodDef methods[] = {
    {"dumpb", py_dumpb, METH_O, "Serialise an object to UBJSON bytes."},
    {"loadb", py_loadb, METH_O, "Deserialise UBJSON bytes."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_ubjson_native_torch",
    "Native UBJSON Draft-12 codec for al26_tpu_torch", -1, methods,
};

PyMODINIT_FUNC PyInit__ubjson_native_torch(void) {
    return PyModule_Create(&moduledef);
}
