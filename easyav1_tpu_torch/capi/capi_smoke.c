// Copy of tools/capi_smoke.c, the JAX package's counterpart.
/* C ABI smoke test of the port: exercises the easyav1.h surface
 * end-to-end (init, metadata, decode, pull + push frames, seek,
 * settings, destroy).  Prints key=value lines, one "frame=" line a
 * frame the video callback receives with its hash (api.frame_hash),
 * and a decode rate measured as tools/easyav1_benchmark.c measures it.
 *
 *     capi_smoke file.webm
 *
 * The session's device and pipe come from the environment
 * (easyav1_tpu_torch/capi/bridge.py). */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "easyav1.h"

static int g_video_cb_frames = 0;
static int g_audio_cb_frames = 0;
static unsigned long long g_luma_sum = 0;

/* api.frame_hash: FNV-style fold over the planes of position-weighted
   sample sums, every product and sum wrapping at 32 bits */
static uint32_t plane_sum(const void *data, size_t stride, unsigned int w,
                          unsigned int h, int wide) {
    uint32_t s = 0;
    for (unsigned int r = 0; r < h; r++) {
        const unsigned char *row = (const unsigned char *)data + r * stride;
        uint32_t wr = 1u + (uint32_t)r * 2654435761u;
        for (unsigned int c = 0; c < w; c++) {
            uint32_t v = wide ? ((const uint16_t *)row)[c] : row[c];
            s += v * (wr + (uint32_t)c * 40503u);
        }
    }
    return s;
}

static uint32_t frame_hash(const easyav1_video_frame *f) {
    unsigned int w = f->properties.width, h = f->properties.height;
    unsigned int cw = w, ch = h;
    switch (f->properties.pixel_layout) {
    case EASYAV1_PIXEL_LAYOUT_YUV420:
        ch = (h + 1) >> 1;
        /* fall through */
    case EASYAV1_PIXEL_LAYOUT_YUV422:
        cw = (w + 1) >> 1;
        break;
    default:
        break;
    }
    int wide = f->properties.bits_per_color != EASYAV1_BITS_PER_COLOR_8;
    uint32_t hash = 2166136261u;
    for (int p = 0; p < 3 && f->data[p]; p++)
        hash = hash * 16777619u
               + plane_sum(f->data[p], f->stride[p], p ? cw : w,
                           p ? ch : h, wide);
    return hash;
}

static void on_video(const easyav1_video_frame *f, void *ud) {
    (void)ud;
    printf("frame=%d ts=%llu hash=%u\n", g_video_cb_frames,
           (unsigned long long)f->timestamp, frame_hash(f));
    g_video_cb_frames++;
    const unsigned char *y = (const unsigned char *)f->data[0];
    for (unsigned int r = 0; r < f->properties.height; r += 16)
        g_luma_sum += y[r * f->stride[0]];
}

static void on_audio(const easyav1_audio_frame *f, void *ud) {
    (void)ud;
    (void)f;
    g_audio_cb_frames++;
}

static double now_ms(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec * 1000.0 + ts.tv_nsec / 1e6;
}

/* tools/easyav1_benchmark.c's measurement: video only, every frame
   decoded, the monotonic clock around the decode loop */
static void decode_rate(const char *path) {
    easyav1_settings s = easyav1_default_settings();
    s.enable_audio = EASYAV1_FALSE;
    s.skip_unprocessed_frames = EASYAV1_FALSE;
    s.log_level = EASYAV1_LOG_LEVEL_ERROR;
    easyav1_t *av = easyav1_init_from_filename(path, &s);
    if (!av) {
        printf("rate_init=0\n");
        return;
    }
    double start = now_ms();
    uint64_t frames = 0;
    while (easyav1_get_status(av) == EASYAV1_STATUS_OK) {
        if (easyav1_decode_next(av) != EASYAV1_STATUS_OK)
            break;
        frames = easyav1_get_total_video_frames_processed(av);
    }
    double total = now_ms() - start;
    printf("rate_status=%d rate_frames=%llu rate_ms=%.3f rate_fps=%.3f\n",
           (int)easyav1_get_status(av), (unsigned long long)frames, total,
           frames / (total / 1000.0));
    easyav1_destroy(&av);
}

int main(int argc, char **argv) {
    if (argc < 2) {
        fprintf(stderr, "usage: %s file.webm\n", argv[0]);
        return 2;
    }
    easyav1_settings s = easyav1_default_settings();
    s.callbacks.video = on_video;
    s.callbacks.audio = on_audio;

    easyav1_t *av = easyav1_init_from_filename(argv[1], &s);
    if (!av) {
        fprintf(stderr, "init failed\n");
        return 1;
    }
    printf("has_video=%d\n", easyav1_has_video_track(av));
    printf("has_audio=%d\n", easyav1_has_audio_track(av));
    printf("width=%u\n", easyav1_get_video_width(av));
    printf("height=%u\n", easyav1_get_video_height(av));
    printf("fps=%u\n", easyav1_get_video_fps(av));
    printf("duration=%llu\n",
           (unsigned long long)easyav1_get_duration(av));
    printf("sample_rate=%u\n", easyav1_get_audio_sample_rate(av));
    printf("channels=%u\n", easyav1_get_audio_channels(av));

    /* decode everything frame by frame (decode_until from 0 would hit
       the >1s catch-up fast-seek, by design) */
    easyav1_status st = EASYAV1_STATUS_OK;
    while (st == EASYAV1_STATUS_OK)
        st = easyav1_decode_next(av);
    printf("decode_status=%d\n", (int)st);
    printf("video_cb_frames=%d\n", g_video_cb_frames);
    printf("audio_cb_frames=%d\n", g_audio_cb_frames);
    printf("luma_sum=%llu\n", g_luma_sum);
    printf("frames_processed=%llu\n",
           (unsigned long long)easyav1_get_total_video_frames_processed(av));

    /* pull path after a seek back to the start; push callbacks are
       cleared first — with a video callback registered, decode_next's
       push delivery pops the frame queue (reference callback_video,
       easyav1.c:2192-2205) and the pull path would see nothing */
    easyav1_settings snocb = easyav1_get_current_settings(av);
    snocb.callbacks.video = NULL;
    snocb.callbacks.audio = NULL;
    easyav1_update_settings(av, &snocb);
    st = easyav1_seek_to_timestamp(av, 0);
    printf("seek_status=%d\n", (int)st);
    while (st == EASYAV1_STATUS_OK &&
           easyav1_has_video_frame(av) == EASYAV1_FALSE)
        st = easyav1_decode_next(av);
    const easyav1_video_frame *vf = easyav1_get_video_frame(av);
    printf("pull_frame=%d\n", vf != NULL);
    if (vf) {
        printf("pull_w=%u pull_h=%u layout=%d\n", vf->properties.width,
               vf->properties.height, (int)vf->properties.pixel_layout);
        printf("pull_hash=%u\n", frame_hash(vf));
    }
    printf("finished=%d\n", easyav1_is_finished(av));

    /* memory init path */
    FILE *f = fopen(argv[1], "rb");
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    void *buf = malloc((size_t)sz);
    if (fread(buf, 1, (size_t)sz, f) != (size_t)sz) return 1;
    fclose(f);
    easyav1_settings s2 = easyav1_default_settings();
    easyav1_t *av2 = easyav1_init_from_memory(buf, (size_t)sz, &s2);
    free(buf);
    printf("mem_init=%d\n", av2 != NULL);
    if (av2) {
        printf("mem_width=%u\n", easyav1_get_video_width(av2));
        easyav1_destroy(&av2);
    }

    easyav1_destroy(&av);
    printf("destroyed=%d\n", av == NULL);
    decode_rate(argv[1]);
    return 0;
}
