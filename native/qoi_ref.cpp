// qoi_ref.cpp — CPU reference QOI codec with a C ABI (loaded via ctypes).
//
// This is the parity oracle and CPU fallback for the device codec.
// It implements the exact QOI semantics documented in SURVEY.md §0, matching
// the behavior of the reference encoder/decoder (reference hot loops:
// source/simple.cpp:17-171, streaming state machines: source/stream.cpp)
// without sharing any of its structure: one translation unit, C-style state
// structs, no templates/concepts.
//
// Build:  g++ -O3 -march=native -std=c++17 -shared -fPIC qoi_ref.cpp -o libqoiref.so

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <cstdio>

namespace {

using u8 = std::uint8_t;
using u32 = std::uint32_t;
using u64 = std::uint64_t;
using i64 = std::int64_t;

constexpr int kHeaderSize = 14;
constexpr int kEndMarkerSize = 8;
constexpr int kRunLimit = 62;
constexpr u8 kEndMarker[8] = {0, 0, 0, 0, 0, 0, 0, 1};

constexpr u8 TAG_RGB = 0xFE;
constexpr u8 TAG_RGBA = 0xFF;
constexpr u8 TAG_INDEX = 0x00;
constexpr u8 TAG_DIFF = 0x40;
constexpr u8 TAG_LUMA = 0x80;
constexpr u8 TAG_RUN = 0xC0;

struct Px {
  u8 r, g, b, a;
};

inline bool same(Px x, Px y) {
  return x.r == y.r && x.g == y.g && x.b == y.b && x.a == y.a;
}

inline u32 hash6(Px p) {
  // (3r + 5g + 7b + 11a) % 64  — SURVEY.md §0 (reference: source/util.hpp:347-351)
  return (p.r * 3u + p.g * 5u + p.b * 7u + p.a * 11u) & 63u;
}

inline Px start_pixel() { return Px{0, 0, 0, 0xFF}; }

inline void put_be32(u8* out, u32 v) {
  out[0] = (u8)(v >> 24);
  out[1] = (u8)(v >> 16);
  out[2] = (u8)(v >> 8);
  out[3] = (u8)v;
}

inline u32 get_be32(const u8* in) {
  return ((u32)in[0] << 24) | ((u32)in[1] << 16) | ((u32)in[2] << 8) | (u32)in[3];
}

inline int diff_in_range(int d) { return d >= -2 && d <= 1; }
inline int luma_g_in_range(int d) { return d >= -32 && d <= 31; }
inline int luma_rb_in_range(int d) { return d >= -8 && d <= 7; }

// Signed wraparound difference of two u8 values, as the reference's
// `i8 d = (u8)(curr - prev)` cast chain produces.
inline int sdiff(u8 a, u8 b) { return (int)(std::int8_t)(u8)(a - b); }

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Header
// ---------------------------------------------------------------------------

// Returns 0 on success. Parses width/height/channels/colorspace.
int qoiref_read_header(const u8* data, u64 size, u32* width, u32* height,
                       u8* channels, u8* colorspace) {
  if (size < kHeaderSize) return -1;
  if (std::memcmp(data, "qoif", 4) != 0) return -2;
  u32 w = get_be32(data + 4);
  u32 h = get_be32(data + 8);
  u8 ch = data[12];
  u8 cs = data[13];
  if ((ch != 3 && ch != 4) || cs > 1 || w == 0 || h == 0) return -3;
  *width = w;
  *height = h;
  *channels = ch;
  *colorspace = cs;
  return 0;
}

// ---------------------------------------------------------------------------
// One-shot encode
//
// Emits chunks into `out` (capacity out_cap).  A chunk is only written if it
// fits entirely ("no torn chunk", SURVEY.md §2 C4).  Returns bytes written;
// sets *complete to whether the whole image (incl. end marker) was emitted.
// ---------------------------------------------------------------------------

u64 qoiref_encode(const u8* pixels, u32 width, u32 height, u8 channels,
                  u8 colorspace, u8* out, u64 out_cap, int* complete) {
  u64 pos = 0;
  bool ok = true;

  auto emit = [&](const u8* bytes, u64 n) {
    if (!ok) return;
    if (pos + n > out_cap) {
      ok = false;
      return;
    }
    std::memcpy(out + pos, bytes, n);
    pos += n;
  };

  // header
  {
    u8 hdr[kHeaderSize];
    std::memcpy(hdr, "qoif", 4);
    put_be32(hdr + 4, width);
    put_be32(hdr + 8, height);
    hdr[12] = channels;
    hdr[13] = colorspace;
    emit(hdr, kHeaderSize);
  }

  Px seen[64] = {};
  Px prev = start_pixel();
  u32 run = 0;
  const u64 n_px = (u64)width * height;
  u64 i = 0;

  for (; i < n_px; ++i) {
    Px curr;
    const u8* p = pixels + i * channels;
    curr.r = p[0];
    curr.g = p[1];
    curr.b = p[2];
    curr.a = channels == 4 ? p[3] : 0xFF;

    if (same(curr, prev)) {
      if (++run == kRunLimit) {
        u8 b = (u8)(TAG_RUN | (run - 1));
        emit(&b, 1);
        if (!ok) { --run; break; }
        run = 0;
      }
    } else {
      if (run > 0) {
        u8 b = (u8)(TAG_RUN | (run - 1));
        emit(&b, 1);
        if (!ok) break;
        run = 0;
      }
      u32 idx = hash6(curr);
      if (same(seen[idx], curr)) {
        u8 b = (u8)(TAG_INDEX | idx);
        emit(&b, 1);
        if (!ok) break;
      } else {
        // Table updated before the alpha test — SURVEY.md §0 step 4
        // (reference: source/simple.cpp:57).
        Px displaced = seen[idx];
        seen[idx] = curr;
        if (channels == 4 && prev.a != curr.a) {
          u8 b[5] = {TAG_RGBA, curr.r, curr.g, curr.b, curr.a};
          emit(b, 5);
          if (!ok) { seen[idx] = displaced; break; }
        } else {
          int dr = sdiff(curr.r, prev.r);
          int dg = sdiff(curr.g, prev.g);
          int db = sdiff(curr.b, prev.b);
          // i8 wraparound, as the reference's `i8 dr_dg = dr - dg` narrowing
          int dr_dg = (int)(std::int8_t)(u8)(dr - dg);
          int db_dg = (int)(std::int8_t)(u8)(db - dg);
          if (diff_in_range(dr) && diff_in_range(dg) && diff_in_range(db)) {
            u8 b = (u8)(TAG_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2));
            emit(&b, 1);
          } else if (luma_rb_in_range(dr_dg) && luma_rb_in_range(db_dg) &&
                     luma_g_in_range(dg)) {
            u8 b[2] = {(u8)(TAG_LUMA | (dg + 32)),
                       (u8)(((dr_dg + 8) << 4) | (db_dg + 8))};
            emit(b, 2);
          } else {
            u8 b[4] = {TAG_RGB, curr.r, curr.g, curr.b};
            emit(b, 4);
          }
          if (!ok) { seen[idx] = displaced; break; }
        }
      }
    }
    prev = curr;
  }

  if (ok && run > 0) {
    u8 b = (u8)(TAG_RUN | (run - 1));
    emit(&b, 1);
  }
  if (ok) emit(kEndMarker, kEndMarkerSize);
  *complete = ok ? 1 : 0;
  return pos;
}

// ---------------------------------------------------------------------------
// One-shot decode (tolerant).
//
// Decodes chunks from in[header..size-end_marker); reads past the end yield
// 0x00 and the loop continues until both input and output are exhausted —
// SURVEY.md §0 "decoder quirks" (reference: source/simple.cpp:100-171).
// `src_channels` is the stream's channel count, `dst_channels` what to write.
// `out` must hold width*height*dst_channels bytes.
// ---------------------------------------------------------------------------

void qoiref_decode(const u8* in, u64 size, u32 width, u32 height,
                   u8 src_channels, u8 dst_channels, u8* out) {
  Px seen[64] = {};
  Px prev = start_pixel();
  seen[hash6(prev)] = prev;

  const u64 n_px = (u64)width * height;
  // Tolerant bound: last 8 bytes are treated as the end marker even if absent.
  const i64 chunks_end = (i64)size - kHeaderSize - kEndMarkerSize;
  i64 di = 0;  // data index relative to header end

  auto rd = [&]() -> u8 {
    i64 abs = kHeaderSize + di++;
    return (abs >= 0 && (u64)abs < size) ? in[abs] : 0x00;
  };
  auto wr = [&](u64 pi, Px px) {
    if (pi >= n_px) return;  // clamp (reference relies on caller buffer size)
    u8* o = out + pi * dst_channels;
    o[0] = px.r;
    o[1] = px.g;
    o[2] = px.b;
    if (dst_channels == 4) o[3] = px.a;
  };

  u64 pi = 0;
  while (di < chunks_end || pi < n_px) {
    u8 tag = rd();
    Px curr = prev;
    if (tag == TAG_RGB) {
      curr.r = rd();
      curr.g = rd();
      curr.b = rd();
    } else if (tag == TAG_RGBA) {
      curr.r = rd();
      curr.g = rd();
      curr.b = rd();
      curr.a = rd();
    } else {
      switch (tag & 0xC0) {
        case TAG_INDEX:
          curr = seen[tag & 0x3F];
          break;
        case TAG_DIFF:
          curr.r = (u8)(prev.r + ((tag >> 4) & 3) - 2);
          curr.g = (u8)(prev.g + ((tag >> 2) & 3) - 2);
          curr.b = (u8)(prev.b + (tag & 3) - 2);
          break;
        case TAG_LUMA: {
          u8 rb = rd();
          int dg = (tag & 0x3F) - 32;
          int dr = dg + ((rb >> 4) & 0xF) - 8;
          int db = dg + (rb & 0xF) - 8;
          curr.r = (u8)(prev.r + dr);
          curr.g = (u8)(prev.g + dg);
          curr.b = (u8)(prev.b + db);
          break;
        }
        case TAG_RUN: {
          // Emits prev `run` times (clamped), without touching prev/seen —
          // SURVEY.md §0 (reference: source/simple.cpp:156-163).
          int run = (tag & 0x3F) + 1;
          while (run-- > 0 && pi < n_px) wr(pi++, prev);
          continue;
        }
      }
    }
    wr(pi++, curr);
    prev = seen[hash6(curr)] = curr;
  }
}

// Vertical flip of a raw image buffer in place.
void qoiref_flip_vertical(u8* data, u32 width, u32 height, u8 channels) {
  const u64 stride = (u64)width * channels;
  u8* tmp = new u8[stride];
  for (u32 y = 0; y < height / 2; ++y) {
    u8* a = data + (u64)y * stride;
    u8* b = data + (u64)(height - 1 - y) * stride;
    std::memcpy(tmp, a, stride);
    std::memcpy(a, b, stride);
    std::memcpy(b, tmp, stride);
  }
  delete[] tmp;
}

// ---------------------------------------------------------------------------
// Streaming codecs — bounded-state resumable encode/decode.
// State layout mirrors the ~260-byte carry identified in SURVEY.md §5:
// channels (engaged flag), run counter, prev pixel, 64-entry table.
// ---------------------------------------------------------------------------

struct StreamState {
  int initialized;   // 0 = not initialized
  u8 channels;       // stream channels
  u8 target;         // decoder target channels
  u32 run;           // pending run counter
  Px prev;
  Px seen[64];
};

u64 qoiref_stream_state_size() { return sizeof(StreamState); }

void qoiref_stream_reset(StreamState* s) {
  s->initialized = 0;
  s->channels = 0;
  s->target = 0;
  s->run = 0;
  s->prev = start_pixel();
  std::memset(s->seen, 0, sizeof(s->seen));
}

// --- encoder ---------------------------------------------------------------

// Writes the header; returns header size, or <0 on error:
// -1 already initialized, -2 out buffer too short.
i64 qoiref_enc_initialize(StreamState* s, u8* out, u64 out_cap, u32 width,
                          u32 height, u8 channels, u8 colorspace) {
  if (s->initialized) return -1;
  if (out_cap < kHeaderSize) return -2;
  std::memcpy(out, "qoif", 4);
  put_be32(out + 4, width);
  put_be32(out + 8, height);
  out[12] = channels;
  out[13] = colorspace;
  qoiref_stream_reset(s);
  s->initialized = 1;
  s->channels = channels;
  return kHeaderSize;
}

// Consumes whole pixels from `in`, emits whole chunks into `out`.  On a full
// output buffer, rolls back the clobbered table slot and un-consumes the
// last pixel (SURVEY.md §2 C7 "transactional rollback"; reference:
// source/stream.cpp:152-236).  Returns processed/written via out-params.
int qoiref_enc_encode(StreamState* s, u8* out, u64 out_cap, const u8* in,
                      u64 in_size, u64* processed, u64* written) {
  if (!s->initialized) return -1;
  if (out_cap == 0 || in_size == 0) return -2;
  if (out_cap < 5) return -3;

  const u8 ch = s->channels;
  const u64 n_px = in_size / ch;  // whole pixels only
  u64 pos = 0;
  bool ok = true;

  auto emit = [&](const u8* bytes, u64 n) -> bool {
    if (pos + n > out_cap) {
      ok = false;
      return false;
    }
    std::memcpy(out + pos, bytes, n);
    pos += n;
    return true;
  };

  u64 i = 0;
  for (; i < n_px; ++i) {
    Px curr;
    const u8* p = in + i * ch;
    curr.r = p[0];
    curr.g = p[1];
    curr.b = p[2];
    curr.a = ch == 4 ? p[3] : 0xFF;

    if (same(curr, s->prev)) {
      if (++s->run == kRunLimit) {
        u8 b = (u8)(TAG_RUN | (s->run - 1));
        if (!emit(&b, 1)) { --s->run; break; }
        s->run = 0;
      }
    } else {
      if (s->run > 0) {
        u8 b = (u8)(TAG_RUN | (s->run - 1));
        if (!emit(&b, 1)) break;
        s->run = 0;
      }
      u32 idx = hash6(curr);
      if (same(s->seen[idx], curr)) {
        u8 b = (u8)(TAG_INDEX | idx);
        if (!emit(&b, 1)) break;
      } else {
        Px displaced = s->seen[idx];
        s->seen[idx] = curr;
        bool wrote;
        if (ch == 4 && s->prev.a != curr.a) {
          u8 b[5] = {TAG_RGBA, curr.r, curr.g, curr.b, curr.a};
          wrote = emit(b, 5);
        } else {
          int dr = sdiff(curr.r, s->prev.r);
          int dg = sdiff(curr.g, s->prev.g);
          int db = sdiff(curr.b, s->prev.b);
          // i8 wraparound, as the reference's `i8 dr_dg = dr - dg` narrowing
          int dr_dg = (int)(std::int8_t)(u8)(dr - dg);
          int db_dg = (int)(std::int8_t)(u8)(db - dg);
          if (diff_in_range(dr) && diff_in_range(dg) && diff_in_range(db)) {
            u8 b = (u8)(TAG_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2));
            wrote = emit(&b, 1);
          } else if (luma_rb_in_range(dr_dg) && luma_rb_in_range(db_dg) &&
                     luma_g_in_range(dg)) {
            u8 b[2] = {(u8)(TAG_LUMA | (dg + 32)),
                       (u8)(((dr_dg + 8) << 4) | (db_dg + 8))};
            wrote = emit(b, 2);
          } else {
            u8 b[4] = {TAG_RGB, curr.r, curr.g, curr.b};
            wrote = emit(b, 4);
          }
        }
        if (!wrote) {
          s->seen[idx] = displaced;  // rollback
          break;
        }
      }
    }
    s->prev = curr;
  }

  (void)ok;
  *processed = i * ch;  // un-consumed pixel excluded automatically
  *written = pos;
  return 0;
}

// Flushes the pending run (if any) + end marker, then resets state.
// Returns bytes written or <0 on error (-3 = TooShort).
i64 qoiref_enc_finalize(StreamState* s, u8* out, u64 out_cap) {
  if (!s->initialized) return -1;
  if (out_cap == 0) return -2;
  u64 need = kEndMarkerSize + (s->run > 0 ? 1 : 0);
  if (out_cap < need) return -3;
  u64 pos = 0;
  if (s->run > 0) out[pos++] = (u8)(TAG_RUN | (s->run - 1));
  std::memcpy(out + pos, kEndMarker, kEndMarkerSize);
  pos += kEndMarkerSize;
  qoiref_stream_reset(s);
  return (i64)pos;
}

// --- decoder ---------------------------------------------------------------

// Parses the header, seeds the table with the start pixel, applies the
// target channel override (0 = keep stream channels).  Returns 0 on success.
int qoiref_dec_initialize(StreamState* s, const u8* in, u64 size, u8 target,
                          u32* width, u32* height, u8* channels,
                          u8* colorspace) {
  if (s->initialized) return -1;
  int rc = qoiref_read_header(in, size, width, height, channels, colorspace);
  if (rc != 0) return rc;
  qoiref_stream_reset(s);
  s->initialized = 1;
  s->channels = *channels;
  s->target = target ? target : *channels;
  s->prev = start_pixel();
  s->seen[hash6(s->prev)] = s->prev;
  return 0;
}

// Decodes whole chunks from `in` into `out` (whole pixels).  A chunk split
// across the input boundary is left unconsumed; a pending OP_RUN persists in
// state and continues emitting on the next call / drain_run.
int qoiref_dec_decode(StreamState* s, u8* out, u64 out_cap, const u8* in,
                      u64 in_size, u64* processed, u64* written) {
  if (!s->initialized) return -1;
  if (out_cap == 0) return -2;
  const u8 tch = s->target;
  if (out_cap < tch) return -3;

  const u64 max_px = out_cap / tch;
  u64 di = 0;
  u64 pi = 0;

  auto wr = [&](Px px) {
    u8* o = out + pi * tch;
    o[0] = px.r;
    o[1] = px.g;
    o[2] = px.b;
    if (tch == 4) o[3] = px.a;
    ++pi;
  };

  while (pi < max_px) {
    if (s->run > 0) {
      --s->run;
      wr(s->prev);
      continue;
    }
    if (di >= in_size) break;
    u8 tag = in[di];
    // chunk length from the tag byte alone
    u64 need = 1;
    if (tag == TAG_RGB) need = 4;
    else if (tag == TAG_RGBA) need = 5;
    else if ((tag & 0xC0) == TAG_LUMA) need = 2;
    if (di + need > in_size) break;  // partial chunk: leave unconsumed

    Px curr = s->prev;
    if (tag == TAG_RGB) {
      curr.r = in[di + 1];
      curr.g = in[di + 2];
      curr.b = in[di + 3];
    } else if (tag == TAG_RGBA) {
      curr.r = in[di + 1];
      curr.g = in[di + 2];
      curr.b = in[di + 3];
      curr.a = in[di + 4];
    } else {
      switch (tag & 0xC0) {
        case TAG_INDEX:
          curr = s->seen[tag & 0x3F];
          break;
        case TAG_DIFF:
          curr.r = (u8)(s->prev.r + ((tag >> 4) & 3) - 2);
          curr.g = (u8)(s->prev.g + ((tag >> 2) & 3) - 2);
          curr.b = (u8)(s->prev.b + (tag & 3) - 2);
          break;
        case TAG_LUMA: {
          u8 rb = in[di + 1];
          int dg = (tag & 0x3F) - 32;
          curr.r = (u8)(s->prev.r + dg + ((rb >> 4) & 0xF) - 8);
          curr.g = (u8)(s->prev.g + dg);
          curr.b = (u8)(s->prev.b + dg + (rb & 0xF) - 8);
          break;
        }
        case TAG_RUN: {
          // store run in state, emit via the loop head (incl. this call)
          di += 1;
          s->run = (u32)(tag & 0x3F) + 1;
          continue;
        }
      }
    }
    di += need;
    wr(curr);
    s->prev = s->seen[hash6(curr)] = curr;
  }

  *processed = di;
  *written = pi * tch;
  return 0;
}

// Emits up to out_cap/channels pixels of the pending run; returns bytes written.
i64 qoiref_dec_drain_run(StreamState* s, u8* out, u64 out_cap) {
  if (!s->initialized) return -1;
  if (out_cap == 0) return -2;
  const u8 tch = s->target;
  u64 pi = 0;
  while (s->run > 0 && (pi + 1) * tch <= out_cap) {
    u8* o = out + pi * tch;
    o[0] = s->prev.r;
    o[1] = s->prev.g;
    o[2] = s->prev.b;
    if (tch == 4) o[3] = s->prev.a;
    ++pi;
    --s->run;
  }
  return (i64)(pi * tch);
}

u32 qoiref_dec_run_count(const StreamState* s) { return s->run; }
u8 qoiref_stream_channels(const StreamState* s) { return s->channels; }
u8 qoiref_dec_target(const StreamState* s) { return s->target; }
int qoiref_stream_is_initialized(const StreamState* s) { return s->initialized; }

// ---------------------------------------------------------------------------
// Batch loader — the native data-loader feeding the device pipelines.
//
// Reads QOI files straight into a caller-owned padded (B, row) batch buffer
// (zero-filled tails), recording per-file byte sizes.  One syscall-bound
// pass, no Python in the loop.  Returns 0 on success, or 1-based index of
// the first file that failed to open/read/fit.
// ---------------------------------------------------------------------------

u64 qoiref_pack_files(const char** paths, u64 n, u8* out, u64 row,
                      u64* sizes) {
  for (u64 i = 0; i < n; ++i) {
    std::FILE* f = std::fopen(paths[i], "rb");
    if (!f) return i + 1;
    u8* dst = out + i * row;
    u64 total = 0;
    for (;;) {
      size_t got = std::fread(dst + total, 1, row - total, f);
      total += got;
      if (got == 0) break;
      if (total == row) {
        // file larger than the row: check for trailing data
        int c = std::fgetc(f);
        if (c != EOF) {
          std::fclose(f);
          return i + 1;
        }
        break;
      }
    }
    std::fclose(f);
    std::memset(dst + total, 0, row - total);
    sizes[i] = total;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Chunk-walk split planner — host-side planning for the device SPLIT-replay
// engine (one over-cap stream's chunk field spread across replay lanes).
//
// Walks the chunk sequence of a QOI body (bytes after the 14-byte header;
// chunks_size = stream size - 22), accumulating per-chunk cost
//   cost = byte_w * chunk_bytes + px_w * pixels_produced
// and cuts a segment boundary (always ON a chunk boundary — the property
// that keeps the device boundary pass's phase algebra exact per lane) each
// time the running cost crosses the next multiple of total/n_segments.
//
// offsets_out/px_out/chunks_out have capacity n_segments + 1; entry 0 =
// (0, 0, 0), entry k = (byte offset, pixel offset, chunk ordinal) of
// segment k's first chunk, final entry = (chunks_size, total pixels, total
// chunks).  chunks_out feeds the device-side chunk-domain compaction (the
// static compact cap must bound every segment's chunk count); it may be
// null.  Returns the number of segments produced (<= n_segments; empty
// segments are never emitted).
//
// chunk_w adds a per-CHUNK cost term (cost = byte_w*bytes + chunk_w +
// px_w*pixels): with the chunk-domain compaction engaged, a lane's replay
// depth is its CHUNK count, not its byte count — callers re-walk with
// chunk_w set (and byte_w ~ 0) to balance the compacted depth.
//
// ANCHORING: after a cost threshold crossing the cut slides forward (up to
// `lookahead` bytes) to the next OP_RGB/OP_RGBA chunk, so the segment
// OPENS with an absolute-color write.  This is what makes the device-side
// seam fixpoint converge in O(1) rounds on smooth DIFF/LUMA-heavy content:
// a segment whose first chunk is a SET re-anchors the carried pixel
// immediately, so its out-state stops depending on the speculative
// in-state (measured: un-anchored 22 KB photo segments converge one lane
// per round; anchored ones in 2-3 rounds total).  prefer_rgba biases the
// anchor to OP_RGBA (for alpha-varying streams, where OP_RGB keeps the
// carried alpha byte and only OP_RGBA anchors all four components).
// lookahead = 0 disables anchoring.
//
// The walk itself is the sequential part the reference does per-pixel
// (source/simple.cpp:111-170); here it is tag-dispatch only (~1 ns/chunk),
// done ONCE per stream on host — the pixel reconstruction stays on device.
// ---------------------------------------------------------------------------

u64 qoiref_split_points(const u8* body, u64 chunks_size, u64 n_px,
                        u64 n_segments, double byte_w, double px_w,
                        u64 lookahead, int prefer_rgba,
                        u64* offsets_out, u64* px_out, u64* chunks_out,
                        double chunk_w) {
  if (n_segments == 0) return 0;
  auto chunk_len = [](u8 tag) -> u64 {
    if (tag == TAG_RGB) return 4;
    if (tag == TAG_RGBA) return 5;
    if ((tag & 0xC0) == TAG_LUMA) return 2;
    return 1;  // INDEX / DIFF / RUN
  };
  auto chunk_px = [](u8 tag) -> u64 {
    if (tag != TAG_RGB && tag != TAG_RGBA && (tag & 0xC0) == TAG_RUN)
      return (u64)(tag & 0x3F) + 1;
    return 1;
  };
  // pass 1: total cost (pixels clamped to what the image still owes,
  // mirroring the decoder's RUN clamp, reference simple.cpp:156-163)
  double total = 0.0;
  {
    u64 pos = 0, px = 0;
    while (pos < chunks_size) {
      const u8 tag = body[pos];
      const u64 len = chunk_len(tag);
      u64 npx = chunk_px(tag);
      if (px + npx > n_px) npx = (n_px > px) ? n_px - px : 0;
      total += byte_w * (double)len + chunk_w + px_w * (double)npx;
      pos += len;
      px += npx;
    }
  }
  if (total <= 0.0) {  // empty body: one trivial segment
    offsets_out[0] = 0;
    px_out[0] = 0;
    offsets_out[1] = chunks_size;
    px_out[1] = 0;
    if (chunks_out) { chunks_out[0] = 0; chunks_out[1] = 0; }
    return 1;
  }
  const double step = total / (double)n_segments;
  // pass 2: cut at cost thresholds, sliding each cut to a SET anchor
  u64 nseg = 0;      // segments closed so far
  u64 next_k = 1;    // next threshold index to cross
  offsets_out[0] = 0;
  px_out[0] = 0;
  if (chunks_out) chunks_out[0] = 0;
  double acc = 0.0;
  u64 pos = 0, px = 0, ci = 0;
  // pending cut state: armed when a threshold is crossed; the cut lands
  // on the next anchor chunk (or after `lookahead` bytes, unanchored)
  bool armed = false;
  u64 arm_pos = 0;
  bool have_rgb = false;
  u64 rgb_pos = 0, rgb_px = 0, rgb_ci = 0;
  while (pos < chunks_size) {
    const u8 tag = body[pos];
    if (armed) {
      const bool is_rgba = tag == TAG_RGBA;
      const bool is_rgb = tag == TAG_RGB;
      bool cut_here = prefer_rgba ? is_rgba : (is_rgb || is_rgba);
      if (is_rgb && prefer_rgba && !have_rgb) {
        have_rgb = true;  // fallback anchor if no RGBA appears in time
        rgb_pos = pos;
        rgb_px = px;
        rgb_ci = ci;
      }
      if (!cut_here && pos - arm_pos >= lookahead) {
        if (have_rgb) {  // late: take the RGB anchor we passed
          ++nseg;
          offsets_out[nseg] = rgb_pos;
          px_out[nseg] = rgb_px;
          if (chunks_out) chunks_out[nseg] = rgb_ci;
          armed = false;
          have_rgb = false;
        } else {
          cut_here = true;  // no anchor in budget: plain cut
        }
      }
      if (cut_here && armed) {
        ++nseg;
        offsets_out[nseg] = pos;
        px_out[nseg] = px;
        if (chunks_out) chunks_out[nseg] = ci;
        armed = false;
        have_rgb = false;
      }
    }
    const u64 len = chunk_len(tag);
    u64 npx = chunk_px(tag);
    if (px + npx > n_px) npx = (n_px > px) ? n_px - px : 0;
    acc += byte_w * (double)len + chunk_w + px_w * (double)npx;
    pos += len;
    px += npx;
    ++ci;
    if (!armed && pos < chunks_size && next_k < n_segments &&
        nseg + 1 < n_segments && acc >= step * (double)next_k) {
      armed = true;  // next anchor (or lookahead expiry) cuts
      arm_pos = pos;
      // skip every threshold this chunk already passed so one giant
      // chunk never spawns a cascade of near-empty segments
      while (next_k < n_segments && acc >= step * (double)next_k) ++next_k;
    }
  }
  ++nseg;
  offsets_out[nseg] = chunks_size;
  px_out[nseg] = px;
  if (chunks_out) chunks_out[nseg] = ci;
  return nseg;
}

}  // extern "C"

