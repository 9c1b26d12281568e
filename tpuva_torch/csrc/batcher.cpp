// Host staging ring for tpuva_torch: frames are written once, straight into
// the caller's batch slots, and a BGR->gray pixel kernel.
//
// The counterpart of native/batcher.cpp, with the copies taken out. The
// ring owns no batch memory: the caller hands it `nslots` slot pointers,
// each `batch * frame_bytes` bytes (on a CUDA device the stager's pinned
// host buffers, on the CPU plain arrays). A slot is owned by one side at a
// time:
//
//   free  --push (first row)-->  filling (producer)
//   filling  --batch full, or finish-->  ready (queued for the consumer)
//   ready  --pop-->  popped (consumer)
//   popped  --release-->  free
//
// The producer copies each frame into the next row of its filling slot
// without holding the lock (no other thread touches that slot), with
// non-temporal stores. Sealing a
// partial slot at finish() pads it by repeating the last frame. Nothing
// is allocated after create. A slot returns to the producer only through
// release(): the stager calls it once the slot's copy to the device has
// completed.
//
// Plain C interface, bound with ctypes (ctypes.CDLL releases the GIL for
// the duration of each call):
//   h = tvt_ring_create(frame_bytes, batch, nslots, slots)
//   producer: tvt_ring_push(h, frame) x T, then tvt_ring_finish(h)
//   consumer: n = tvt_ring_pop(h, &slot)   // n valid rows; 0: the end
//             ... tvt_ring_release(h, slot)
//   either side: tvt_ring_close(h)         // abort: wakes both sides
//   tvt_ring_destroy(h)                    // after both sides are done

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <utility>
#include <vector>
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

// Copy a frame into its row with non-temporal stores: the row is read
// next by the copy to the device, not by this core, and a frame (2 MB at
// 1080p) is below the size where memcpy stops allocating the destination
// in the cache. The fence makes the stores visible before the slot is
// sealed.
void copy_row(uint8_t* dst, const uint8_t* src, size_t n) {
#if defined(__SSE2__)
  size_t i = 0;
  for (; i < n && (reinterpret_cast<uintptr_t>(dst + i) & 15); ++i) dst[i] = src[i];
  for (; i + 64 <= n; i += 64) {
    __m128i a = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i));
    __m128i b = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i + 16));
    __m128i c = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i + 32));
    __m128i d = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i + 48));
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i), a);
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i + 16), b);
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i + 32), c);
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i + 48), d);
  }
  for (; i < n; ++i) dst[i] = src[i];
  _mm_sfence();
#else
  std::memcpy(dst, src, n);
#endif
}

struct Ring {
  size_t frame_bytes;
  int batch;
  std::vector<uint8_t*> slots;

  std::mutex mu;
  std::condition_variable cv_free;   // producer waits for a free slot
  std::condition_variable cv_ready;  // consumer waits for a ready slot
  std::deque<int> free_slots;
  std::deque<std::pair<int, int>> ready;  // (slot, n_valid)
  bool finished = false;  // the producer sealed its last slot
  bool closed = false;    // aborted by either side

  // producer-owned: the slot being filled and its rows so far
  int fill = -1;
  int staged = 0;

  Ring(size_t fb, int b, int n, uint8_t* const* s)
      : frame_bytes(fb), batch(b), slots(s, s + n) {
    for (int i = 0; i < n; ++i) free_slots.push_back(i);
  }

  uint8_t* row(int slot, int r) const {
    return slots[slot] + static_cast<size_t>(r) * frame_bytes;
  }

  // Queue the filling slot with n_valid = staged (the producer's thread).
  void seal() {
    std::lock_guard<std::mutex> lk(mu);
    ready.emplace_back(fill, staged);
    fill = -1;
    staged = 0;
    cv_ready.notify_one();
  }
};

}  // namespace

extern "C" {

void* tvt_ring_create(size_t frame_bytes, int batch, int nslots,
                      uint8_t* const* slots) {
  if (frame_bytes == 0 || batch <= 0 || nslots <= 0 || slots == nullptr)
    return nullptr;
  return new Ring(frame_bytes, batch, nslots, slots);
}

// 0, or -1 once the ring is closed
int tvt_ring_push(void* h, const uint8_t* frame) {
  auto* r = static_cast<Ring*>(h);
  {
    std::unique_lock<std::mutex> lk(r->mu);
    if (r->fill < 0)
      r->cv_free.wait(lk, [&] { return !r->free_slots.empty() || r->closed; });
    if (r->closed) return -1;
    if (r->fill < 0) {
      r->fill = r->free_slots.front();
      r->free_slots.pop_front();
    }
  }
  copy_row(r->row(r->fill, r->staged), frame, r->frame_bytes);
  if (++r->staged == r->batch) r->seal();
  return 0;
}

// Seal the last, partial slot (its tail rows repeat the last frame) and
// mark the end of the stream; pop returns 0 once the ready slots are gone.
void tvt_ring_finish(void* h) {
  auto* r = static_cast<Ring*>(h);
  if (r->fill >= 0 && r->staged > 0) {
    for (int i = r->staged; i < r->batch; ++i)
      copy_row(r->row(r->fill, i), r->row(r->fill, r->staged - 1),
               r->frame_bytes);
    r->seal();
  }
  std::lock_guard<std::mutex> lk(r->mu);
  r->finished = true;
  r->cv_ready.notify_all();
}

// n_valid (> 0) and *slot; 0 at the end of the stream or once closed
int tvt_ring_pop(void* h, int* slot) {
  auto* r = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv_ready.wait(lk, [&] {
    return !r->ready.empty() || r->finished || r->closed;
  });
  if (r->closed || r->ready.empty()) return 0;
  auto item = r->ready.front();
  r->ready.pop_front();
  *slot = item.first;
  return item.second;
}

// Give a popped slot back to the producer; -1 for a slot out of range
int tvt_ring_release(void* h, int slot) {
  auto* r = static_cast<Ring*>(h);
  if (slot < 0 || slot >= static_cast<int>(r->slots.size())) return -1;
  std::lock_guard<std::mutex> lk(r->mu);
  r->free_slots.push_back(slot);
  r->cv_free.notify_one();
  return 0;
}

void tvt_ring_close(void* h) {
  auto* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->mu);
  r->closed = true;
  r->cv_free.notify_all();
  r->cv_ready.notify_all();
}

// slots queued for the consumer
int tvt_ring_depth(void* h) {
  auto* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->mu);
  return static_cast<int>(r->ready.size());
}

void tvt_ring_destroy(void* h) { delete static_cast<Ring*>(h); }

// BGR (interleaved, uint8) -> gray, tpuva's 14-bit fixed-point weights:
// gray = (1868*B + 9617*G + 4899*R + 8192) >> 14 (within 1 of OpenCV 5's
// cvtColor BGR2GRAY, which rounds 15-bit weights)
void tvt_bgr2gray(const uint8_t* src, uint8_t* dst, size_t npx) {
  for (size_t i = 0; i < npx; ++i) {
    const uint8_t* p = src + 3 * i;
    dst[i] =
        (uint8_t)((1868u * p[0] + 9617u * p[1] + 4899u * p[2] + 8192u) >> 14);
  }
}

}  // extern "C"
