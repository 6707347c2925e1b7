// Native host code for audfprint_torch: the data-loader (a copy of
// native/audfp_host.cpp of the JAX package) and the streamed route's
// backward prune.
//
// Role: the host-side analog of the reference's decode layer
// (audio_read.py, SURVEY §2.3.1).  The reference shells out to ffmpeg per
// file; at device ingest rates the host becomes the bottleneck, so the bulk
// path here does RIFF/WAVE parsing, PCM->float32 conversion, and channel
// mixing in C++ with a std::thread pool, filling a zero-padded batch matrix
// ready for device transfer.  bwd_prune_sparse is the streamed route's
// backward prune over the sparse forward peaks, the same float32 decision
// sequence as oracle.analyze.bwd_prune_sparse.  Exposed to Python via
// ctypes (audfprint_torch/utils/native.py); every entry point has a
// NumPy or Python fallback.
//
// Build: at first use, by audfprint_torch/utils/native.py
// (g++ -O3 -shared -fPIC into build/audfprint_torch/).  No -ffast-math and
// no FTZ/DAZ: the prune's envelope decays into subnormals over long
// silences, and NumPy keeps them.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <thread>
#include <vector>
#include <atomic>

extern "C" {

// ---------------------------------------------------------------------------
// PCM conversion primitives (match utils/audio.py buf_to_float semantics)
// ---------------------------------------------------------------------------

void s16_to_f32_mono(const int16_t* in, int64_t n_frames, int n_ch,
                     float* out) {
    const float scale = 1.0f / 32768.0f;
    if (n_ch == 1) {
        for (int64_t i = 0; i < n_frames; ++i) out[i] = in[i] * scale;
        return;
    }
    const float inv = 1.0f / n_ch;
    for (int64_t i = 0; i < n_frames; ++i) {
        float acc = 0.0f;
        for (int c = 0; c < n_ch; ++c) acc += in[i * n_ch + c] * scale;
        out[i] = acc * inv;
    }
}

void u8_to_f32_mono(const uint8_t* in, int64_t n_frames, int n_ch,
                    float* out) {
    const float scale = 1.0f / 128.0f;
    const float inv = 1.0f / n_ch;
    for (int64_t i = 0; i < n_frames; ++i) {
        float acc = 0.0f;
        for (int c = 0; c < n_ch; ++c)
            acc += (static_cast<float>(in[i * n_ch + c]) - 128.0f) * scale;
        out[i] = acc * inv;
    }
}

void s24_to_f32_mono(const uint8_t* in, int64_t n_frames, int n_ch,
                     float* out) {
    const float scale = 1.0f / 8388608.0f;
    const float inv = 1.0f / n_ch;
    for (int64_t i = 0; i < n_frames; ++i) {
        float acc = 0.0f;
        for (int c = 0; c < n_ch; ++c) {
            const uint8_t* p = in + 3 * (i * n_ch + c);
            int32_t v = p[0] | (p[1] << 8) | (p[2] << 16);
            if (v >= (1 << 23)) v -= (1 << 24);
            acc += v * scale;
        }
        out[i] = acc * inv;
    }
}

void s32_to_f32_mono(const int32_t* in, int64_t n_frames, int n_ch,
                     float* out) {
    const float scale = 1.0f / 2147483648.0f;
    const float inv = 1.0f / n_ch;
    for (int64_t i = 0; i < n_frames; ++i) {
        float acc = 0.0f;
        for (int c = 0; c < n_ch; ++c) acc += in[i * n_ch + c] * scale;
        out[i] = acc * inv;
    }
}

// ---------------------------------------------------------------------------
// Minimal RIFF/WAVE reader (PCM 8/16/24/32-bit)
// ---------------------------------------------------------------------------

struct WavInfo {
    int sample_rate = 0;
    int n_channels = 0;
    int bits = 0;
    int64_t n_frames = 0;   // per channel
};

// returns 0 on success; fills out (caller buffer, capacity max_samples)
// and info.  error codes: 1 open, 2 header, 3 format, 4 read.
static int read_wav_file(const char* path, float* out, int64_t max_samples,
                         WavInfo* info) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    fseek(f, 0, SEEK_END);
    const int64_t fsize = ftell(f);
    fseek(f, 0, SEEK_SET);
    uint8_t hdr[12];
    if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) ||
        memcmp(hdr + 8, "WAVE", 4)) { fclose(f); return 2; }
    uint16_t fmt = 0, n_ch = 0, bits = 0;
    uint32_t sr = 0;
    bool have_fmt = false;
    std::vector<uint8_t> data;
    while (true) {
        uint8_t ch[8];
        if (fread(ch, 1, 8, f) != 8) break;
        uint32_t sz;
        memcpy(&sz, ch + 4, 4);
        if (!memcmp(ch, "fmt ", 4)) {
            // a PCM fmt chunk is >= 16 bytes; a smaller (malformed) one
            // would send the bits read past the buffer.  Cap the size too
            // (a crafted 4 GB chunk length must not drive the allocation).
            if (sz < 16 || sz > (1u << 20)) { fclose(f); return 2; }
            std::vector<uint8_t> buf(sz);
            if (fread(buf.data(), 1, sz, f) != sz) { fclose(f); return 4; }
            memcpy(&fmt, buf.data(), 2);
            memcpy(&n_ch, buf.data() + 2, 2);
            memcpy(&sr, buf.data() + 4, 4);
            memcpy(&bits, buf.data() + 14, 2);
            have_fmt = true;
        } else if (!memcmp(ch, "data", 4)) {
            // clamp the declared size to the bytes actually in the file:
            // streaming encoders write 0xFFFFFFFF, and a crafted length
            // must never drive the allocation past the file itself
            int64_t remaining = fsize - ftell(f);
            if (remaining < 0) remaining = 0;
            uint64_t szc = sz;
            if (szc > static_cast<uint64_t>(remaining))
                szc = static_cast<uint64_t>(remaining);
            data.resize(szc);
            size_t got = fread(data.data(), 1, szc, f);
            data.resize(got);
            break;
        } else {
            fseek(f, (sz + 1) & ~1u, SEEK_CUR);
        }
    }
    fclose(f);
    if (!have_fmt || data.empty()) return 2;
    if (fmt != 1 || n_ch == 0) return 3;   // PCM only (float wav -> python)
    int bytes = bits / 8;
    if (bytes < 1 || bytes > 4 || bits % 8) return 3;
    int64_t frames = static_cast<int64_t>(data.size()) / (bytes * n_ch);
    if (frames > max_samples) frames = max_samples;
    switch (bits) {
        case 16: s16_to_f32_mono(reinterpret_cast<int16_t*>(data.data()),
                                 frames, n_ch, out); break;
        case 8:  u8_to_f32_mono(data.data(), frames, n_ch, out); break;
        case 24: s24_to_f32_mono(data.data(), frames, n_ch, out); break;
        case 32: s32_to_f32_mono(reinterpret_cast<int32_t*>(data.data()),
                                 frames, n_ch, out); break;
        default: return 3;
    }
    info->sample_rate = sr;
    info->n_channels = n_ch;
    info->bits = bits;
    info->n_frames = frames;
    return 0;
}

// Batch loader: n files -> zero-padded (n, max_samples) float32 matrix.
// paths: array of n C strings.  out shape (n, max_samples) pre-zeroed by
// caller.  lens[i] = decoded frame count (0 on failure), srs[i] = sample
// rate, errs[i] = error code.  n_threads workers.
void load_wav_batch(const char** paths, int n, float* out,
                    int64_t max_samples, int32_t* lens, int32_t* srs,
                    int32_t* errs, int n_threads) {
    std::atomic<int> next(0);
    auto worker = [&]() {
        while (true) {
            int i = next.fetch_add(1);
            if (i >= n) return;
            WavInfo info;
            int rc = read_wav_file(paths[i], out + int64_t(i) * max_samples,
                                   max_samples, &info);
            errs[i] = rc;
            lens[i] = rc == 0 ? static_cast<int32_t>(info.n_frames) : 0;
            srs[i] = rc == 0 ? info.sample_rate : 0;
        }
    };
    int nt = n_threads < 1 ? 1 : n_threads;
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
}

// Backward decaying-threshold prune over a sparse forward-peak stream,
// bit for bit with oracle.analyze.bwd_prune_sparse.  Peaks i in [0, n):
// frame pk_t[i] (ascending), bin pk_pos[i] in [0, F), value pk_val[i].
// sthresh (F) holds the envelope seed and is updated in place; gvec has
// 2 * gsize + 1 taps.  Walks frames n_frames-1 .. 0: within a frame, peaks
// by value, then bin, then index, all descending; a peak at least the
// envelope at its bin is kept, raises the envelope to val * gvec around
// it and clears the peak at (t + 1, bin) (the last index of a duplicate
// pair, as the oracle's dict holds); any other peak is dropped.  Every
// frame then decays the envelope by a_dec.  Peaks outside [0, n_frames)
// are never visited.  keep (n) is filled with 0/1.  Returns 0, or -1 with
// keep unfilled when the input is not one the loop takes (pk_t not
// ascending, a bin outside [0, F), a NaN value, which leaves std::sort
// no order), for the caller's fallback.
int bwd_prune_sparse(int64_t n_frames, int64_t n, const int64_t* pk_t,
                     const int64_t* pk_pos, const float* pk_val, int64_t F,
                     float* sthresh, const float* gvec, int64_t gsize,
                     float a_dec, uint8_t* keep) {
    for (int64_t i = 0; i < n; ++i) {
        if ((i > 0 && pk_t[i] < pk_t[i - 1]) || pk_pos[i] < 0 ||
            pk_pos[i] >= F || std::isnan(pk_val[i]))
            return -1;
    }
    std::fill(keep, keep + n, uint8_t(1));
    if (n_frames <= 0) return 0;
    // last[b]: the last peak index registered at bin b; it belongs to
    // frame t + 1 only when pk_t says so
    std::vector<int64_t> last(F, -1);
    std::vector<int64_t> order;
    int64_t e = n;
    while (e > 0 && pk_t[e - 1] > n_frames) --e;
    int64_t b = e;
    while (b > 0 && pk_t[b - 1] == n_frames) --b;
    for (int64_t i = b; i < e; ++i) last[pk_pos[i]] = i;
    e = b;
    for (int64_t t = n_frames - 1; t >= 0; --t) {
        b = e;
        while (b > 0 && pk_t[b - 1] == t) --b;
        if (b < e) {
            order.clear();
            for (int64_t i = b; i < e; ++i) order.push_back(i);
            std::sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
                if (pk_val[x] != pk_val[y]) return pk_val[x] > pk_val[y];
                if (pk_pos[x] != pk_pos[y]) return pk_pos[x] > pk_pos[y];
                return x > y;
            });
            for (int64_t i : order) {
                const float val = pk_val[i];
                const int64_t pos = pk_pos[i];
                if (val >= sthresh[pos]) {
                    const int64_t lo = std::max<int64_t>(0, pos - gsize);
                    const int64_t hi = std::min<int64_t>(F, pos + gsize + 1);
                    for (int64_t k = lo; k < hi; ++k) {
                        const float v = val * gvec[k - pos + gsize];
                        if (v > sthresh[k]) sthresh[k] = v;
                    }
                    const int64_t j = last[pos];
                    if (j >= 0 && pk_t[j] == t + 1) keep[j] = 0;
                } else {
                    keep[i] = 0;
                }
            }
            for (int64_t i = b; i < e; ++i) last[pk_pos[i]] = i;
        }
        for (int64_t k = 0; k < F; ++k) sthresh[k] *= a_dec;
        e = b;
    }
    return 0;
}

}  // extern "C"
