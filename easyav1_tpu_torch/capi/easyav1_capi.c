// Copy of easyav1_tpu/capi/easyav1_capi.c, the JAX package's counterpart.
/* easyav1 C ABI over the PyTorch/CUDA port, easyav1_tpu_torch.
 *
 * Thin embedding shim: each easyav1_t holds a Python `Instance`
 * (easyav1_tpu_torch/capi/bridge.py) wrapping the port's EasyAV1
 * session, which decodes on the card unless the environment asks for
 * the CPU or the C path (bridge.py); calls marshal through
 * the CPython API (no pybind11).  Pull getters copy plane/PCM data into
 * per-handle buffers that stay valid until the next pull, matching the
 * reference's lifetime contract; push callbacks fire from the Python
 * playback thread through ctypes trampolines.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdlib.h>
#include <string.h>

#include "easyav1.h"

struct easyav1_t {
    PyObject *obj;                 /* bridge.Instance */
    easyav1_settings settings;
    easyav1_video_frame vframe;
    void *vdata[3];
    size_t vcap[3];
    easyav1_audio_frame aframe;
    float *abuf;
    size_t acap;
    const float *achan_ptrs[8];
};

static PyObject *g_bridge = NULL;

static int ensure_python(void) {
    if (g_bridge) return 1;
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        /* release the GIL so PyGILState_Ensure works from any thread */
        PyEval_SaveThread();
    }
    PyGILState_STATE st = PyGILState_Ensure();
    /* make the package importable regardless of cwd/PYTHONPATH: try
       the executable's ancestors (easyav1_tpu_torch/_build/<tool> ->
       repo root) and the cwd, appended after any existing entries.
       Only the port's package is ever imported from there */
    PyRun_SimpleString(
        "import os, sys\n"
        "cands = [os.getcwd()]\n"
        "try:\n"
        "    exe = os.path.realpath('/proc/self/exe')\n"
        "    d = os.path.dirname(exe)\n"
        "    for _ in range(4):\n"
        "        cands.append(d)\n"
        "        d = os.path.dirname(d)\n"
        "except OSError:\n"
        "    pass\n"
        "for c in cands:\n"
        "    if (os.path.isdir(os.path.join(c, 'easyav1_tpu_torch'))\n"
        "            and c not in sys.path):\n"
        "        sys.path.append(c)\n");
    PyObject *mod = PyImport_ImportModule("easyav1_tpu_torch.capi.bridge");
    if (!mod) {
        PyErr_Print();
        PyGILState_Release(st);
        return 0;
    }
    g_bridge = mod;
    PyGILState_Release(st);
    return 1;
}

easyav1_settings easyav1_default_settings(void) {
    easyav1_settings s;
    memset(&s, 0, sizeof(s));
    s.enable_video = EASYAV1_TRUE;
    s.enable_audio = EASYAV1_TRUE;
    s.skip_unprocessed_frames = EASYAV1_TRUE;
    s.interlace_audio = EASYAV1_TRUE;
    s.close_handle_on_destroy = EASYAV1_FALSE;
    s.video_track = 0;
    s.audio_track = 0;
    s.use_fast_seeking = EASYAV1_FALSE;
    s.audio_offset_time = 0;
    s.log_level = EASYAV1_LOG_LEVEL_WARNING;
    return s;
}

static PyObject *settings_dict(const easyav1_settings *s) {
    return Py_BuildValue(
        "{s:i,s:i,s:i,s:i,s:i,s:I,s:I,s:i,s:L,s:i}",
        "enable_video", (int)s->enable_video,
        "enable_audio", (int)s->enable_audio,
        "skip_unprocessed_frames", (int)s->skip_unprocessed_frames,
        "interlace_audio", (int)s->interlace_audio,
        "close_handle_on_destroy", (int)s->close_handle_on_destroy,
        "video_track", s->video_track,
        "audio_track", s->audio_track,
        "use_fast_seeking", (int)s->use_fast_seeking,
        "audio_offset_time", (long long)s->audio_offset_time,
        "log_level", (int)s->log_level);
}

static void set_callbacks(easyav1_t *h) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(
        g_bridge, "set_c_callbacks", "OLLL", h->obj,
        (long long)(intptr_t)h->settings.callbacks.video,
        (long long)(intptr_t)h->settings.callbacks.audio,
        (long long)(intptr_t)h->settings.callbacks.userdata);
    if (!r) PyErr_Print();
    Py_XDECREF(r);
    PyGILState_Release(st);
}

static easyav1_t *init_common(PyObject *obj, const easyav1_settings *s) {
    if (!obj) return NULL;
    easyav1_t *h = calloc(1, sizeof(easyav1_t));
    if (!h) {
        Py_DECREF(obj);
        return NULL;
    }
    h->obj = obj;
    h->settings = s ? *s : easyav1_default_settings();
    if (h->settings.callbacks.video || h->settings.callbacks.audio)
        set_callbacks(h);
    return h;
}

easyav1_t *easyav1_init_from_filename(const char *filename,
                                      const easyav1_settings *settings) {
    if (!filename || !ensure_python()) return NULL;
    easyav1_settings def = easyav1_default_settings();
    const easyav1_settings *s = settings ? settings : &def;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *d = settings_dict(s);
    PyObject *obj = PyObject_CallMethod(g_bridge, "create_from_filename",
                                        "sO", filename, d);
    Py_XDECREF(d);
    if (!obj) PyErr_Print();
    PyGILState_Release(st);
    return init_common(obj, s);
}

easyav1_t *easyav1_init_from_memory(const void *data, size_t size,
                                    const easyav1_settings *settings) {
    if (!data || !size || !ensure_python()) return NULL;
    easyav1_settings def = easyav1_default_settings();
    const easyav1_settings *s = settings ? settings : &def;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *d = settings_dict(s);
    PyObject *obj = PyObject_CallMethod(g_bridge, "create_from_memory",
                                        "y#O", (const char *)data,
                                        (Py_ssize_t)size, d);
    Py_XDECREF(d);
    if (!obj) PyErr_Print();
    PyGILState_Release(st);
    return init_common(obj, s);
}

easyav1_t *easyav1_init_from_file(FILE *f,
                                  const easyav1_settings *settings) {
    if (!f) return NULL;
    /* slurp the stream (the core demuxer then owns a memory view) */
    long pos = ftell(f);
    if (fseek(f, 0, SEEK_END) != 0) return NULL;
    long end = ftell(f);
    fseek(f, pos < 0 ? 0 : pos, SEEK_SET);
    size_t size = (size_t)(end - (pos < 0 ? 0 : pos));
    void *buf = malloc(size ? size : 1);
    if (!buf) return NULL;
    size_t got = fread(buf, 1, size, f);
    easyav1_t *h = easyav1_init_from_memory(buf, got, settings);
    free(buf);
    return h;
}

easyav1_t *easyav1_init_from_custom_stream(const easyav1_stream *stream,
                                           const easyav1_settings *settings) {
    if (!stream || !stream->read_func || !stream->seek_func
        || !stream->tell_func)
        return NULL;
    /* drain the stream through the callbacks into memory */
    if (stream->seek_func(0, SEEK_END, stream->userdata) != 0) return NULL;
    int64_t end = stream->tell_func(stream->userdata);
    if (end <= 0 || stream->seek_func(0, SEEK_SET, stream->userdata) != 0)
        return NULL;
    void *buf = malloc((size_t)end);
    if (!buf) return NULL;
    if (stream->read_func(buf, (size_t)end, stream->userdata) != 1) {
        free(buf);
        return NULL;
    }
    easyav1_t *h = easyav1_init_from_memory(buf, (size_t)end, settings);
    free(buf);
    return h;
}

/* -- generic call helpers --------------------------------------------- */

static long long call_ll(const easyav1_t *h, const char *name,
                         long long dflt) {
    if (!h || !h->obj) return dflt;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(g_bridge, name, "O", h->obj);
    long long v = dflt;
    if (r) {
        v = PyLong_AsLongLong(r);
        Py_DECREF(r);
    } else {
        PyErr_Print();
    }
    PyGILState_Release(st);
    return v;
}

static long long call_ll1(const easyav1_t *h, const char *name,
                          long long arg, long long dflt) {
    if (!h || !h->obj) return dflt;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(g_bridge, name, "OL", h->obj, arg);
    long long v = dflt;
    if (r) {
        v = PyLong_AsLongLong(r);
        Py_DECREF(r);
    } else {
        PyErr_Print();
    }
    PyGILState_Release(st);
    return v;
}

/* -- decode / playback / seek ----------------------------------------- */

easyav1_status easyav1_decode_next(easyav1_t *h) {
    return (easyav1_status)call_ll(h, "decode_next",
                                   EASYAV1_STATUS_INVALID_ARGUMENT);
}

easyav1_status easyav1_decode_until(easyav1_t *h, easyav1_timestamp ts) {
    return (easyav1_status)call_ll1(h, "decode_until", (long long)ts,
                                    EASYAV1_STATUS_INVALID_ARGUMENT);
}

easyav1_status easyav1_decode_for(easyav1_t *h, easyav1_timestamp time) {
    return (easyav1_status)call_ll1(h, "decode_for", (long long)time,
                                    EASYAV1_STATUS_INVALID_ARGUMENT);
}

easyav1_status easyav1_play(easyav1_t *h) {
    return (easyav1_status)call_ll(h, "play",
                                   EASYAV1_STATUS_INVALID_ARGUMENT);
}

void easyav1_stop(easyav1_t *h) {
    call_ll(h, "stop", 0);
}

easyav1_status easyav1_seek_to_timestamp(easyav1_t *h,
                                         easyav1_timestamp ts) {
    return (easyav1_status)call_ll1(h, "seek_to_timestamp", (long long)ts,
                                    EASYAV1_STATUS_INVALID_ARGUMENT);
}

easyav1_status easyav1_seek_forward(easyav1_t *h, easyav1_timestamp t) {
    return (easyav1_status)call_ll1(h, "seek_forward", (long long)t,
                                    EASYAV1_STATUS_INVALID_ARGUMENT);
}

easyav1_status easyav1_seek_backward(easyav1_t *h, easyav1_timestamp t) {
    return (easyav1_status)call_ll1(h, "seek_backward", (long long)t,
                                    EASYAV1_STATUS_INVALID_ARGUMENT);
}

/* -- state getters ----------------------------------------------------- */

easyav1_status easyav1_get_status(const easyav1_t *h) {
    return (easyav1_status)call_ll(h, "get_status", EASYAV1_STATUS_ERROR);
}

easyav1_timestamp easyav1_get_current_timestamp(const easyav1_t *h) {
    return (easyav1_timestamp)call_ll(h, "get_current_timestamp", 0);
}

easyav1_bool easyav1_has_video_track(const easyav1_t *h) {
    return (easyav1_bool)call_ll(h, "has_video_track", 0);
}

easyav1_bool easyav1_has_audio_track(const easyav1_t *h) {
    return (easyav1_bool)call_ll(h, "has_audio_track", 0);
}

unsigned int easyav1_get_total_video_tracks(const easyav1_t *h) {
    return (unsigned int)call_ll(h, "get_total_video_tracks", 0);
}

unsigned int easyav1_get_total_audio_tracks(const easyav1_t *h) {
    return (unsigned int)call_ll(h, "get_total_audio_tracks", 0);
}

unsigned int easyav1_get_video_width(const easyav1_t *h) {
    return (unsigned int)call_ll(h, "get_video_width", 0);
}

unsigned int easyav1_get_video_height(const easyav1_t *h) {
    return (unsigned int)call_ll(h, "get_video_height", 0);
}

unsigned int easyav1_get_video_fps(const easyav1_t *h) {
    return (unsigned int)call_ll(h, "get_video_fps", 0);
}

unsigned int easyav1_get_audio_channels(const easyav1_t *h) {
    return (unsigned int)call_ll(h, "get_audio_channels", 0);
}

unsigned int easyav1_get_audio_sample_rate(const easyav1_t *h) {
    return (unsigned int)call_ll(h, "get_audio_sample_rate", 0);
}

easyav1_timestamp easyav1_get_duration(const easyav1_t *h) {
    return (easyav1_timestamp)call_ll(h, "get_duration", 0);
}

uint64_t easyav1_get_total_video_frames_processed(const easyav1_t *h) {
    return (uint64_t)call_ll(h, "get_total_video_frames_processed", 0);
}

easyav1_bool easyav1_is_finished(const easyav1_t *h) {
    return (easyav1_bool)call_ll(h, "is_finished", 0);
}

easyav1_bool easyav1_has_video_frame(const easyav1_t *h) {
    return (easyav1_bool)call_ll(h, "has_video_frame", 0);
}

easyav1_bool easyav1_is_audio_buffer_filled(const easyav1_t *h) {
    return (easyav1_bool)call_ll(h, "is_audio_buffer_filled", 0);
}

/* -- frame pulls -------------------------------------------------------- */

const easyav1_video_frame *easyav1_get_video_frame(easyav1_t *h) {
    if (!h || !h->obj) return NULL;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(g_bridge, "get_video_frame_raw", "O",
                                      h->obj);
    if (!r || r == Py_None) {
        if (!r) PyErr_Print();
        Py_XDECREF(r);
        PyGILState_Release(st);
        return NULL;
    }
    PyObject *props, *planes, *strides;
    unsigned long long ts;
    if (!PyArg_ParseTuple(r, "OKOO", &props, &ts, &planes, &strides)) {
        PyErr_Print();
        Py_DECREF(r);
        PyGILState_Release(st);
        return NULL;
    }
    easyav1_video_frame *f = &h->vframe;
    int pv[9];
    for (int i = 0; i < 9; i++)
        pv[i] = (int)PyLong_AsLong(PyTuple_GetItem(props, i));
    f->properties.pixel_layout = (easyav1_pixel_layout)pv[0];
    f->properties.bits_per_color = (easyav1_bits_per_color)pv[1];
    f->properties.color_space = (easyav1_color_space)pv[2];
    f->properties.color_primaries = (easyav1_color_primaries)pv[3];
    f->properties.transfer_characteristics =
        (easyav1_transfer_characteristics)pv[4];
    f->properties.matrix_coefficients = (easyav1_matrix_coefficients)pv[5];
    f->properties.chroma_sample_position =
        (easyav1_chroma_sample_position)pv[6];
    f->properties.width = (unsigned int)pv[7];
    f->properties.height = (unsigned int)pv[8];
    f->timestamp = ts;
    Py_ssize_t n = PyList_Size(planes);
    for (int i = 0; i < 3; i++) {
        if (i < n) {
            PyObject *b = PyList_GetItem(planes, i);
            char *data;
            Py_ssize_t len;
            PyBytes_AsStringAndSize(b, &data, &len);
            if ((size_t)len > h->vcap[i]) {
                h->vdata[i] = realloc(h->vdata[i], (size_t)len);
                h->vcap[i] = (size_t)len;
            }
            memcpy(h->vdata[i], data, (size_t)len);
            f->data[i] = h->vdata[i];
            f->stride[i] = (size_t)PyLong_AsSize_t(
                PyList_GetItem(strides, i));
        } else {
            f->data[i] = NULL;
            f->stride[i] = 0;
        }
    }
    Py_DECREF(r);
    PyGILState_Release(st);
    return f;
}

const easyav1_audio_frame *easyav1_get_audio_frame(easyav1_t *h) {
    if (!h || !h->obj) return NULL;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(g_bridge, "get_audio_frame_raw", "O",
                                      h->obj);
    if (!r || r == Py_None) {
        if (!r) PyErr_Print();
        Py_XDECREF(r);
        PyGILState_Release(st);
        return NULL;
    }
    unsigned int channels, samples;
    unsigned long long ts;
    unsigned long long nbytes;
    int interlaced;
    PyObject *payload;
    if (!PyArg_ParseTuple(r, "IIKKiO", &channels, &samples, &ts, &nbytes,
                          &interlaced, &payload)) {
        PyErr_Print();
        Py_DECREF(r);
        PyGILState_Release(st);
        return NULL;
    }
    easyav1_audio_frame *f = &h->aframe;
    f->channels = channels;
    f->samples = samples;
    f->timestamp = ts;
    f->bytes = (size_t)nbytes;
    size_t total = (size_t)samples * channels * sizeof(float);
    if (total > h->acap) {
        h->abuf = realloc(h->abuf, total);
        h->acap = total;
    }
    if (interlaced) {
        char *data;
        Py_ssize_t len;
        PyBytes_AsStringAndSize(payload, &data, &len);
        memcpy(h->abuf, data, (size_t)len);
        f->pcm.interlaced = h->abuf;
    } else {
        size_t per = (size_t)samples * sizeof(float);
        for (unsigned int c = 0; c < channels && c < 8; c++) {
            PyObject *b = PyList_GetItem(payload, c);
            char *data;
            Py_ssize_t len;
            PyBytes_AsStringAndSize(b, &data, &len);
            memcpy((char *)h->abuf + c * per, data, (size_t)len);
            h->achan_ptrs[c] = (const float *)((char *)h->abuf + c * per);
        }
        f->pcm.deinterlaced = h->achan_ptrs;
    }
    Py_DECREF(r);
    PyGILState_Release(st);
    return f;
}

/* -- settings ----------------------------------------------------------- */

easyav1_settings easyav1_get_current_settings(const easyav1_t *h) {
    if (!h) return easyav1_default_settings();
    return h->settings;
}

easyav1_status easyav1_update_settings(easyav1_t *h,
                                       const easyav1_settings *settings) {
    if (!h || !h->obj || !settings) return EASYAV1_STATUS_INVALID_ARGUMENT;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *d = settings_dict(settings);
    PyObject *r = PyObject_CallMethod(g_bridge, "update_settings", "OO",
                                      h->obj, d);
    long long v = EASYAV1_STATUS_ERROR;
    if (r) {
        v = PyLong_AsLongLong(r);
        Py_DECREF(r);
    } else {
        PyErr_Print();
    }
    Py_XDECREF(d);
    PyGILState_Release(st);
    h->settings = *settings;
    if (settings->callbacks.video || settings->callbacks.audio)
        set_callbacks(h);
    return (easyav1_status)v;
}

void easyav1_destroy(easyav1_t **handle) {
    if (!handle || !*handle) return;
    easyav1_t *h = *handle;
    if (h->obj) {
        PyGILState_STATE st = PyGILState_Ensure();
        PyObject *r = PyObject_CallMethod(g_bridge, "destroy", "O", h->obj);
        if (!r) PyErr_Print();
        Py_XDECREF(r);
        Py_DECREF(h->obj);
        PyGILState_Release(st);
    }
    for (int i = 0; i < 3; i++) free(h->vdata[i]);
    free(h->abuf);
    free(h);
    *handle = NULL;
}
