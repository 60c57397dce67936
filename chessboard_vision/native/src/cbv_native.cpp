// Native host runtime for chessboard_vision.
//
// Two components (the framework's C++ runtime layer — the counterpart of
// the reference's Cython-as-C++ modules, but doing real work):
//
// 1. cbv_resample_*: SIMD-friendly bilinear warp + square extraction on the
//    host. Same arithmetic as the device path (per-channel f32 lerp,
//    round-half-even, constant-0 border via per-tap oob masks), driven by
//    the same calibration-time static plan (anchor index + fractions).
//    Used by the CPU fallback backend and by capture-side pre-warping.
//
// 2. cbv_ring_*: a lock-free single-producer single-consumer frame ring
//    buffer for the camera-thread -> pipeline-thread handoff (replaces the
//    reference's implicit "latest frame wins" cv2 polling with bounded,
//    copy-in slots and drop-oldest semantics).
//
// Build: make -C chessboard_vision/native   (produces libcbv_native.so)
// Python binding: ctypes (chessboard_vision/native/__init__.py).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Bilinear resample: queries with static anchor indices and fractions.
// frame: HWC u8 BGR. For query j:
//   anchor = idx[j] (flat index y*W+x), taps anchor, +1, +W, +W+1
//   oob[j] bit t set -> tap t contributes 0
//   out_c[j] = round_half_even(lerp2d(taps_c))
// ---------------------------------------------------------------------------

static inline float lerp2(float p00, float p01, float p10, float p11,
                          float fx, float fy) {
  float top = p00 + fx * (p01 - p00);
  float bot = p10 + fx * (p11 - p10);
  return top + fy * (bot - top);
}

static inline uint8_t round_u8(float v) {
  // round-half-even, clamp to [0, 255] (matches jnp.round + clip)
  float r = nearbyintf(v);
  if (r < 0.f) r = 0.f;
  if (r > 255.f) r = 255.f;
  return (uint8_t)r;
}

void cbv_resample_bgr(const uint8_t* frame, int64_t src_w,
                      const int32_t* idx, const float* fx, const float* fy,
                      const uint8_t* oob, int64_t n_queries,
                      uint8_t* out_b, uint8_t* out_g, uint8_t* out_r) {
  const int64_t stride = src_w * 3;
  for (int64_t j = 0; j < n_queries; ++j) {
    const int64_t a = (int64_t)idx[j] * 3;
    const uint8_t m = oob[j];
    const float w_x = fx[j], w_y = fy[j];
    for (int c = 0; c < 3; ++c) {
      float p00 = (m & 1) ? 0.f : (float)frame[a + c];
      float p01 = (m & 2) ? 0.f : (float)frame[a + 3 + c];
      float p10 = (m & 4) ? 0.f : (float)frame[a + stride + c];
      float p11 = (m & 8) ? 0.f : (float)frame[a + stride + 3 + c];
      float v = lerp2(p00, p01, p10, p11, w_x, w_y);
      uint8_t r8 = round_u8(v);
      if (c == 0) out_b[j] = r8;
      else if (c == 1) out_g[j] = r8;
      else out_r[j] = r8;
    }
  }
}

// Resample + exact fixed-point grayscale in one pass
// (gray = (R*9798 + G*19235 + B*3735 + 2^14) >> 15, the cv2 u8 formula).
void cbv_resample_gray(const uint8_t* frame, int64_t src_w,
                       const int32_t* idx, const float* fx, const float* fy,
                       const uint8_t* oob, int64_t n_queries, uint8_t* out) {
  const int64_t stride = src_w * 3;
  for (int64_t j = 0; j < n_queries; ++j) {
    const int64_t a = (int64_t)idx[j] * 3;
    const uint8_t m = oob[j];
    const float w_x = fx[j], w_y = fy[j];
    int32_t ch[3];
    for (int c = 0; c < 3; ++c) {
      float p00 = (m & 1) ? 0.f : (float)frame[a + c];
      float p01 = (m & 2) ? 0.f : (float)frame[a + 3 + c];
      float p10 = (m & 4) ? 0.f : (float)frame[a + stride + c];
      float p11 = (m & 8) ? 0.f : (float)frame[a + stride + 3 + c];
      ch[c] = (int32_t)round_u8(lerp2(p00, p01, p10, p11, w_x, w_y));
    }
    out[j] = (uint8_t)((ch[2] * 9798 + ch[1] * 19235 + ch[0] * 3735 + (1 << 14)) >> 15);
  }
}

// HWC -> planar conversion (the pipeline's device frame layout).
void cbv_to_planar(const uint8_t* hwc, int64_t h, int64_t w, uint8_t* planar) {
  const int64_t n = h * w;
  for (int64_t i = 0; i < n; ++i) {
    planar[i] = hwc[i * 3];
    planar[n + i] = hwc[i * 3 + 1];
    planar[2 * n + i] = hwc[i * 3 + 2];
  }
}

// ---------------------------------------------------------------------------
// SPSC frame ring buffer (drop-oldest when full).
//
// Lap-tolerant seqlock design: the producer writes unconditionally (it may
// lap a slow consumer) and NEVER touches consumer state; the consumer owns
// `tail` exclusively and detects laps/torn slots via per-slot sequence
// words. Each slot's state word holds 2*frame_idx+1 while the producer is
// copying into it and 2*frame_idx+2 once the frame is complete; a reader
// that observes a state change across its copy (or a state that does not
// match the frame index it expected) knows the slot was overwritten
// mid-copy and skips forward. Frames skipped this way are counted in
// `dropped` by the consumer.
// ---------------------------------------------------------------------------

struct CbvRing {
  std::vector<uint8_t> data;
  std::vector<std::atomic<int64_t>> state;  // per-slot seqlock word
  int64_t slot_bytes;
  int64_t n_slots;
  std::atomic<int64_t> head;     // frames pushed (producer-owned)
  std::atomic<int64_t> tail;     // frames consumed/skipped (consumer-owned)
  std::atomic<int64_t> dropped;  // consumer-counted overwritten frames

  CbvRing(int64_t sb, int64_t n)
      : data(sb * n), state(n), slot_bytes(sb), n_slots(n),
        head(0), tail(0), dropped(0) {
    for (auto& s : state) s.store(0, std::memory_order_relaxed);
  }
};

void* cbv_ring_create(int64_t slot_bytes, int64_t n_slots) {
  return new CbvRing(slot_bytes, n_slots);
}

void cbv_ring_destroy(void* ring) { delete (CbvRing*)ring; }

// Producer: copy a frame in (overwrites the oldest slot when full).
// Returns its sequence number (frame index + 1).
int64_t cbv_ring_push(void* ring, const uint8_t* frame) {
  CbvRing* r = (CbvRing*)ring;
  const int64_t n = r->head.load(std::memory_order_relaxed);
  const int64_t slot = n % r->n_slots;
  r->state[slot].store(2 * n + 1, std::memory_order_relaxed);  // writing
  std::atomic_thread_fence(std::memory_order_seq_cst);
  std::memcpy(&r->data[slot * r->slot_bytes], frame, r->slot_bytes);
  std::atomic_thread_fence(std::memory_order_seq_cst);
  r->state[slot].store(2 * n + 2, std::memory_order_release);  // complete
  r->head.store(n + 1, std::memory_order_release);
  return n + 1;
}

// Consumer: copy the next surviving frame out. Returns its sequence number
// (frame index + 1), 0 if empty.
int64_t cbv_ring_pop(void* ring, uint8_t* out) {
  CbvRing* r = (CbvRing*)ring;
  int64_t t = r->tail.load(std::memory_order_relaxed);
  for (;;) {
    const int64_t h = r->head.load(std::memory_order_acquire);
    if (t >= h) {
      r->tail.store(t, std::memory_order_release);
      return 0;
    }
    if (h - t > r->n_slots) {  // producer lapped us: frames gone for good
      const int64_t skip = (h - r->n_slots) - t;
      r->dropped.fetch_add(skip, std::memory_order_relaxed);
      t = h - r->n_slots;
    }
    const int64_t slot = t % r->n_slots;
    const int64_t s1 = r->state[slot].load(std::memory_order_acquire);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    std::memcpy(out, &r->data[slot * r->slot_bytes], r->slot_bytes);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    const int64_t s2 = r->state[slot].load(std::memory_order_acquire);
    if (s1 == s2 && s1 == 2 * t + 2) {  // clean read of the expected frame
      r->tail.store(t + 1, std::memory_order_release);
      return t + 1;
    }
    // Slot was overwritten mid-copy (or holds a newer frame already):
    // frame t is unrecoverable; count it and move on.
    r->dropped.fetch_add(1, std::memory_order_relaxed);
    ++t;
  }
}

// Consumer: skip to the most recent frame (drop backlog), like the
// reference's SKIP_FRAMES polling. Returns frames skipped.
int64_t cbv_ring_skip_to_latest(void* ring) {
  CbvRing* r = (CbvRing*)ring;
  const int64_t t = r->tail.load(std::memory_order_relaxed);
  const int64_t h = r->head.load(std::memory_order_acquire);
  if (h - t <= 1) return 0;
  const int64_t skipped = h - 1 - t;
  r->tail.store(h - 1, std::memory_order_release);
  return skipped;
}

int64_t cbv_ring_size(void* ring) {
  CbvRing* r = (CbvRing*)ring;
  const int64_t t = r->tail.load(std::memory_order_acquire);
  const int64_t h = r->head.load(std::memory_order_acquire);
  const int64_t sz = h - t;
  return sz > r->n_slots ? r->n_slots : (sz < 0 ? 0 : sz);
}

int64_t cbv_ring_dropped(void* ring) {
  return ((CbvRing*)ring)->dropped.load();
}

}  // extern "C"
