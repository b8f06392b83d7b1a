// Copy of easyav1_tpu/capi/easyav1.h, the JAX package's counterpart.
/* easyav1 C API — the PyTorch/CUDA port.
 *
 * Drop-in surface for the easyav1 library (reference src/easyav1.h):
 * the same types, enums and 33 entry points, so tools written against
 * the original header (player, benchmark) compile unchanged.  Behind
 * the ABI sits easyav1_tpu_torch: native C entropy decode, then frame
 * reconstruction with the port's CUDA kernels on the card
 * (capi/bridge.py says how a session picks its device and pipe).
 */
#ifndef EASYAV1_TPU_CAPI_H
#define EASYAV1_TPU_CAPI_H

#include <stddef.h>
#include <stdint.h>
#include <stdio.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct easyav1_t easyav1_t;
typedef uint64_t easyav1_timestamp;

typedef enum { EASYAV1_FALSE = 0, EASYAV1_TRUE = 1 } easyav1_bool;

typedef enum {
    EASYAV1_STATUS_ERROR = 0,
    EASYAV1_STATUS_OK = 1,
    EASYAV1_STATUS_FINISHED = 2,
    EASYAV1_STATUS_INVALID_ARGUMENT = -1,
    EASYAV1_STATUS_OUT_OF_MEMORY = -2,
    EASYAV1_STATUS_IO_ERROR = -3,
    EASYAV1_STATUS_DECODER_ERROR = -4,
    EASYAV1_STATUS_NOT_IMPLEMENTED = -5,
    EASYAV1_STATUS_INVALID_STATE = -6,
    EASYAV1_STATUS_INVALID_DATA = -7,
    EASYAV1_STATUS_UNSUPPORTED = -8
} easyav1_status;

/* custom stream callbacks: fread/fseek/ftell-shaped */
typedef int (*easyav1_read_func)(void *buffer, size_t size, void *userdata);
typedef int (*easyav1_seek_func)(int64_t offset, int origin, void *userdata);
typedef int64_t (*easyav1_tell_func)(void *userdata);

typedef struct {
    easyav1_read_func read_func;
    easyav1_seek_func seek_func;
    easyav1_tell_func tell_func;
    void *userdata;
} easyav1_stream;

typedef enum {
    EASYAV1_PIXEL_LAYOUT_UNKNOWN = 0,
    EASYAV1_PIXEL_LAYOUT_YUV400 = 1,
    EASYAV1_PIXEL_LAYOUT_YUV420 = 2,
    EASYAV1_PIXEL_LAYOUT_YUV422 = 3,
    EASYAV1_PIXEL_LAYOUT_YUV444 = 4
} easyav1_pixel_layout;

typedef enum {
    EASYAV1_COLOR_SPACE_UNKNOWN = 0,
    EASYAV1_COLOR_SPACE_LIMITED = 1,
    EASYAV1_COLOR_SPACE_FULL = 2
} easyav1_color_space;

typedef enum {
    EASYAV1_BITS_PER_COLOR_UNKNOWN = 0,
    EASYAV1_BITS_PER_COLOR_8 = 1,
    EASYAV1_BITS_PER_COLOR_10 = 2,
    EASYAV1_BITS_PER_COLOR_12 = 3
} easyav1_bits_per_color;

typedef enum {
    EASYAV1_COLOR_PRIMARIES_UNSPECIFIED = 0,
    EASYAV1_COLOR_PRIMARIES_BT709 = 1,
    EASYAV1_COLOR_PRIMARIES_UNKNOWN = 2,
    EASYAV1_COLOR_PRIMARIES_BT470M = 3,
    EASYAV1_COLOR_PRIMARIES_BT470BG = 4,
    EASYAV1_COLOR_PRIMARIES_BT601 = 5,
    EASYAV1_COLOR_PRIMARIES_SMPTE240 = 6,
    EASYAV1_COLOR_PRIMARIES_FILM = 7,
    EASYAV1_COLOR_PRIMARIES_BT2020 = 8,
    EASYAV1_COLOR_PRIMARIES_XYZ = 9,
    EASYAV1_COLOR_PRIMARIES_SMPTE431 = 10,
    EASYAV1_COLOR_PRIMARIES_SMPTE432 = 11,
    EASYAV1_COLOR_PRIMARIES_EBU3213 = 12
} easyav1_color_primaries;

typedef enum {
    EASYAV1_TRANSFER_CHARACTERISTICS_UNSPECIFIED = 0,
    EASYAV1_TRANSFER_CHARACTERISTICS_BT709 = 1,
    EASYAV1_TRANSFER_CHARACTERISTICS_UNKNOWN = 2,
    EASYAV1_TRANSFER_CHARACTERISTICS_BT470M = 3,
    EASYAV1_TRANSFER_CHARACTERISTICS_BT470BG = 4,
    EASYAV1_TRANSFER_CHARACTERISTICS_BT601 = 5,
    EASYAV1_TRANSFER_CHARACTERISTICS_SMPTE240 = 6,
    EASYAV1_TRANSFER_CHARACTERISTICS_LINEAR = 7,
    EASYAV1_TRANSFER_CHARACTERISTICS_LOG_100 = 8,
    EASYAV1_TRANSFER_CHARACTERISTICS_LOG_100_SQRT = 9,
    EASYAV1_TRANSFER_CHARACTERISTICS_IEC61966 = 10,
    EASYAV1_TRANSFER_CHARACTERISTICS_BT1361 = 11,
    EASYAV1_TRANSFER_CHARACTERISTICS_SRGB = 12,
    EASYAV1_TRANSFER_CHARACTERISTICS_BT2020_10 = 13,
    EASYAV1_TRANSFER_CHARACTERISTICS_BT2020_12 = 14,
    EASYAV1_TRANSFER_CHARACTERISTICS_SMPTE2084 = 15,
    EASYAV1_TRANSFER_CHARACTERISTICS_SMPTE428 = 16,
    EASYAV1_TRANSFER_CHARACTERISTICS_HLG = 17
} easyav1_transfer_characteristics;

typedef enum {
    EASYAV1_MATRIX_COEFFICIENTS_UNSPECIFIED = 0,
    EASYAV1_MATRIX_COEFFICIENTS_IDENTITY = 1,
    EASYAV1_MATRIX_COEFFICIENTS_BT709 = 2,
    EASYAV1_MATRIX_COEFFICIENTS_UNKNOWN = 3,
    EASYAV1_MATRIX_COEFFICIENTS_FCC = 4,
    EASYAV1_MATRIX_COEFFICIENTS_BT470BG = 5,
    EASYAV1_MATRIX_COEFFICIENTS_BT601 = 6,
    EASYAV1_MATRIX_COEFFICIENTS_SMPTE240 = 7,
    EASYAV1_MATRIX_COEFFICIENTS_SMPTE_YCGCO = 8,
    EASYAV1_MATRIX_COEFFICIENTS_BT2020_NCL = 9,
    EASYAV1_MATRIX_COEFFICIENTS_BT2020_CL = 10,
    EASYAV1_MATRIX_COEFFICIENTS_SMPTE2085 = 11,
    EASYAV1_MATRIX_COEFFICIENTS_CHROMATICITY_NCL = 12,
    EASYAV1_MATRIX_COEFFICIENTS_CHROMATICITY_CL = 13,
    EASYAV1_MATRIX_COEFFICIENTS_ICTCP = 14
} easyav1_matrix_coefficients;

typedef enum {
    EASYAV1_CHROMA_SAMPLE_POSITION_UNKNOWN = 0,
    EASYAV1_CHROMA_SAMPLE_POSITION_VERTICAL = 1,
    EASYAV1_CHROMA_SAMPLE_POSITION_COLOCATED = 2
} easyav1_chroma_sample_position;

typedef struct {
    struct {
        easyav1_pixel_layout pixel_layout;
        easyav1_bits_per_color bits_per_color;
        easyav1_color_space color_space;
        easyav1_color_primaries color_primaries;
        easyav1_transfer_characteristics transfer_characteristics;
        easyav1_matrix_coefficients matrix_coefficients;
        easyav1_chroma_sample_position chroma_sample_position;
        unsigned int width;
        unsigned int height;
    } properties;
    easyav1_timestamp timestamp;
    const void *data[3];
    size_t stride[3];
} easyav1_video_frame;

typedef struct {
    unsigned int channels;
    unsigned int samples;
    easyav1_timestamp timestamp;
    size_t bytes;
    union {
        const float **deinterlaced;
        const float *interlaced;
    } pcm;
} easyav1_audio_frame;

typedef void (*easyav1_video_callback)(const easyav1_video_frame *frame,
                                       void *userdata);
typedef void (*easyav1_audio_callback)(const easyav1_audio_frame *frame,
                                       void *userdata);

typedef enum {
    EASYAV1_LOG_LEVEL_ERROR,
    EASYAV1_LOG_LEVEL_WARNING,
    EASYAV1_LOG_LEVEL_INFO
} easyav1_log_level_t;

typedef struct {
    easyav1_bool enable_video;
    easyav1_bool enable_audio;
    easyav1_bool skip_unprocessed_frames;
    easyav1_bool interlace_audio;
    easyav1_bool close_handle_on_destroy;
    struct {
        easyav1_video_callback video;
        easyav1_audio_callback audio;
        void *userdata;
    } callbacks;
    unsigned int video_track;
    unsigned int audio_track;
    easyav1_bool use_fast_seeking;
    int64_t audio_offset_time;
    easyav1_log_level_t log_level;
} easyav1_settings;

/* -- lifecycle ------------------------------------------------------- */

easyav1_settings easyav1_default_settings(void);
easyav1_t *easyav1_init_from_filename(const char *filename,
                                      const easyav1_settings *settings);
easyav1_t *easyav1_init_from_file(FILE *f, const easyav1_settings *settings);
easyav1_t *easyav1_init_from_memory(const void *data, size_t size,
                                    const easyav1_settings *settings);
easyav1_t *easyav1_init_from_custom_stream(const easyav1_stream *stream,
                                           const easyav1_settings *settings);
void easyav1_destroy(easyav1_t **handle);

/* -- decoding -------------------------------------------------------- */

easyav1_status easyav1_decode_next(easyav1_t *handle);
easyav1_status easyav1_decode_until(easyav1_t *handle,
                                    easyav1_timestamp timestamp);
easyav1_status easyav1_decode_for(easyav1_t *handle, easyav1_timestamp time);

/* -- playback -------------------------------------------------------- */

easyav1_status easyav1_play(easyav1_t *handle);
void easyav1_stop(easyav1_t *handle);

/* -- seeking --------------------------------------------------------- */

easyav1_status easyav1_seek_forward(easyav1_t *handle,
                                    easyav1_timestamp time);
easyav1_status easyav1_seek_backward(easyav1_t *handle,
                                     easyav1_timestamp time);
easyav1_status easyav1_seek_to_timestamp(easyav1_t *handle,
                                         easyav1_timestamp timestamp);

/* -- state ----------------------------------------------------------- */

easyav1_status easyav1_get_status(const easyav1_t *handle);
easyav1_timestamp easyav1_get_current_timestamp(const easyav1_t *handle);
easyav1_bool easyav1_has_video_track(const easyav1_t *handle);
easyav1_bool easyav1_has_audio_track(const easyav1_t *handle);
unsigned int easyav1_get_total_video_tracks(const easyav1_t *handle);
unsigned int easyav1_get_total_audio_tracks(const easyav1_t *handle);
unsigned int easyav1_get_video_width(const easyav1_t *handle);
unsigned int easyav1_get_video_height(const easyav1_t *handle);
unsigned int easyav1_get_video_fps(const easyav1_t *handle);
unsigned int easyav1_get_audio_channels(const easyav1_t *handle);
unsigned int easyav1_get_audio_sample_rate(const easyav1_t *handle);
easyav1_timestamp easyav1_get_duration(const easyav1_t *handle);
uint64_t easyav1_get_total_video_frames_processed(const easyav1_t *handle);
easyav1_bool easyav1_is_finished(const easyav1_t *handle);

/* -- output ---------------------------------------------------------- */

easyav1_bool easyav1_has_video_frame(const easyav1_t *handle);
const easyav1_video_frame *easyav1_get_video_frame(easyav1_t *handle);
easyav1_bool easyav1_is_audio_buffer_filled(const easyav1_t *handle);
const easyav1_audio_frame *easyav1_get_audio_frame(easyav1_t *handle);

/* -- settings -------------------------------------------------------- */

easyav1_settings easyav1_get_current_settings(const easyav1_t *handle);
easyav1_status easyav1_update_settings(easyav1_t *handle,
                                       const easyav1_settings *settings);

#ifdef __cplusplus
}
#endif

#endif /* EASYAV1_TPU_CAPI_H */
