// Native radar-format decoders for the pysteps_tpu_torch data plane.
//
// The reference framework's IO hot paths run in C/C++ (GDAL, h5py's HDF5,
// OpenCV, the RADOLAN byte-twiddling in NumPy); this library provides the
// equivalent native decode kernels for the formats pysteps_tpu_torch implements
// itself, plus an OpenMP-parallel batch API for archive prefetching.
//
// C ABI, consumed from Python via ctypes (pysteps_tpu_torch/native/__init__.py).
// Build: see pysteps_tpu_torch/native/build.py (g++ -O3 -fopenmp -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Decode a RADOLAN RY/RW-style payload: little-endian uint16 values with
// bit 13 (0x2000) flagging no-data, low 12 bits scaled by `precision`.
// Rows are flipped (RADOLAN stores south to north).
// in:  size*size uint16 values   out: size*size float32
void radolan_decode(const uint16_t* in, float* out, int size, float precision) {
#pragma omp parallel for schedule(static)
    for (int row = 0; row < size; ++row) {
        const uint16_t* src = in + (size - 1 - row) * size;
        float* dst = out + row * size;
        for (int col = 0; col < size; ++col) {
            uint16_t v = src[col];
            if (v & 0x2000u) {
                dst[col] = NAN;
            } else {
                dst[col] = static_cast<float>(v & 0x0FFFu) * precision;
            }
        }
    }
}

// Decode a binary PGM payload (8- or 16-bit big-endian) into float32 with
// the FMI dBZ convention out = (raw - offset) / gain, mapping `nodata`
// to NaN.
void pgm_decode(const uint8_t* in, float* out, int n_pixels, int bytes_per_px,
                float nodata, float offset, float gain) {
#pragma omp parallel for schedule(static)
    for (int i = 0; i < n_pixels; ++i) {
        float v;
        if (bytes_per_px == 1) {
            v = static_cast<float>(in[i]);
        } else {
            v = static_cast<float>((static_cast<uint16_t>(in[2 * i]) << 8) |
                                   in[2 * i + 1]);
        }
        out[i] = (v == nodata) ? NAN : (v - offset) / gain;
    }
}

// Apply a 256-entry lookup table to 8-bit imagery (e.g. the MCH GIF
// rain-rate palette).  Entries holding NaN propagate.
void lut_apply_u8(const uint8_t* in, const float* lut, float* out, int n_pixels) {
#pragma omp parallel for schedule(static)
    for (int i = 0; i < n_pixels; ++i) {
        out[i] = lut[in[i]];
    }
}

// Generic linear calibration raw*gain + offset with nodata/undetect
// sentinel handling — the ODIM HDF5 "what" group contract.
void calibrate_u16(const uint16_t* in, float* out, int n_pixels, float gain,
                   float offset, float nodata, float undetect,
                   float undetect_value) {
#pragma omp parallel for schedule(static)
    for (int i = 0; i < n_pixels; ++i) {
        float v = static_cast<float>(in[i]);
        if (v == nodata) {
            out[i] = NAN;
        } else if (v == undetect) {
            out[i] = undetect_value;
        } else {
            out[i] = v * gain + offset;
        }
    }
}

// Batch RADOLAN decode: n_files independent payloads decoded in parallel
// (archive prefetching; each file's rows additionally parallelize).
void radolan_decode_batch(const uint16_t* const* inputs, float** outputs,
                          int n_files, int size, float precision) {
#pragma omp parallel for schedule(dynamic)
    for (int f = 0; f < n_files; ++f) {
        // per-file decode without nested parallelism
        for (int row = 0; row < size; ++row) {
            const uint16_t* src = inputs[f] + (size - 1 - row) * size;
            float* dst = outputs[f] + row * size;
            for (int col = 0; col < size; ++col) {
                uint16_t v = src[col];
                dst[col] = (v & 0x2000u)
                               ? NAN
                               : static_cast<float>(v & 0x0FFFu) * precision;
            }
        }
    }
}

int omp_thread_count() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
