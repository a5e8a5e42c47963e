// Batched sealed-box opening (and fused open+combine) for the clerk hot loop.
//
// The reference clerk opens every participation's sealed box sequentially
// (client/src/clerk.rs:78-82, with the FIXME at 71-72 about streaming this
// loop). Python threads help only partially — each box still pays ctypes
// call overhead and GIL re-acquisition per box. These native paths process a
// whole clerking job in ONE call on a std::thread pool:
//
// - sda_sealed_open_batch: open + varint-decode every box into a flat
//   caller-provided i64 buffer (per-box offsets derived from plaintext
//   sizes, so one oversized box cannot inflate the whole allocation).
// - sda_sealed_open_combine: open + decode + modular-accumulate, never
//   materialising the decoded share matrix at all — the native answer to
//   clerk.rs:71-72 ("decrypt-then-combine could stream/accumulate").
//
// The port's copy of native/sealed_batch.cpp, with the same C ABI: each box
// is opened by sda_box_seal_open (nacl.cpp, built into the same library and
// wire-identical to libsodium's crypto_box_seal_open); the varint decode
// matches sda_varint_decode in native/varint.cpp.

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
size_t sda_varint_decode(const uint8_t* data, size_t len, int64_t* out,
                         size_t max_out);
size_t sda_varint_count(const uint8_t* data, size_t len);
int sda_box_seal_open(uint8_t* m, const uint8_t* c, uint64_t clen,
                      const uint8_t* pk, const uint8_t* sk);
}

namespace {

constexpr size_t kSealBytes = 48;  // crypto_box_SEALBYTES

// out_lens sentinels (distinct so the caller can reproduce the sequential
// path's exception types: seal_open failure vs malformed varint stream).
constexpr size_t kOpenFailed = SIZE_MAX;
constexpr size_t kDecodeFailed = SIZE_MAX - 1;

template <typename Fn>
void run_pool(size_t count, int n_threads, Fn&& body) {
    std::atomic<size_t> next(0);
    auto worker = [&](size_t tid) {
        for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= count) return;
            if (!body(tid, i)) return;  // body returns false to bail early
        }
    };
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1 || count < 2) {
        worker(0);
        return;
    }
    size_t spawn = std::min<size_t>(n_threads, count);
    std::vector<std::thread> pool;
    pool.reserve(spawn - 1);
    for (size_t t = 1; t < spawn; ++t) pool.emplace_back(worker, t);
    worker(0);
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Open `count` sealed boxes and varint-decode each into the flat buffer
// `out` at slot offset `out_offs[i]` (capacity out_offs[i+1]-out_offs[i],
// sized by the caller from the plaintext length, which bounds the decoded
// count at one value per byte). `boxes` is a contiguous buffer with per-box
// byte offsets `offs[i]..offs[i+1]`. `out_lens[i]` receives the decoded
// share count, or kOpenFailed / kDecodeFailed sentinels. Returns 0.
int sda_sealed_open_batch(const uint8_t* boxes, const size_t* offs,
                          size_t count, const uint8_t* pk, const uint8_t* sk,
                          int64_t* out, const size_t* out_offs,
                          size_t* out_lens, int n_threads) {
    std::vector<std::vector<uint8_t>> scratch(
        std::max<size_t>(1, static_cast<size_t>(std::max(n_threads, 1))));
    run_pool(count, n_threads, [&](size_t tid, size_t i) {
        std::vector<uint8_t>& plain = scratch[tid];
        const uint8_t* box = boxes + offs[i];
        size_t blen = offs[i + 1] - offs[i];
        if (blen < kSealBytes) {
            out_lens[i] = kOpenFailed;
            return true;
        }
        plain.resize(blen - kSealBytes);
        if (sda_box_seal_open(plain.data(), box, static_cast<uint64_t>(blen),
                              pk, sk) != 0) {
            out_lens[i] = kOpenFailed;
            return true;
        }
        size_t cap = out_offs[i + 1] - out_offs[i];
        size_t n = sda_varint_decode(plain.data(), plain.size(),
                                     out + out_offs[i], cap);
        out_lens[i] = (n == SIZE_MAX) ? kDecodeFailed : n;
        return true;
    });
    return 0;
}

// Fused clerk combine: open + decode + accumulate `count` share vectors of
// exactly `dim` elements each, mod `modulus` (< 2^63), into `combined`
// (canonical [0, p) representatives — protocol-equivalent to the
// reference's signed fold; see sda_tpu/engine.py device_combine).
//
// Wire values are canonicalised per element (trunc-domain (-p, p) needs one
// conditional add; anything wider pays a division). Per-thread
// accumulators stay < p via a conditional subtract per add, then fold.
//
// Returns 0 on success; -2 a box failed to open; -3 a box's varint stream
// was malformed; -4 a box decoded to != dim values (-1, "library
// unavailable" in native/sealed_batch.cpp, cannot occur). On -2/-3/-4
// `*fail_index` is one failing box's index.
int sda_sealed_open_combine(const uint8_t* boxes, const size_t* offs,
                            size_t count, const uint8_t* pk,
                            const uint8_t* sk, uint64_t modulus,
                            int64_t* combined, size_t dim, int n_threads,
                            size_t* fail_index) {
    if (n_threads < 1) n_threads = 1;
    size_t n_acc = std::min<size_t>(static_cast<size_t>(n_threads),
                                    std::max<size_t>(count, 1));

    std::vector<std::vector<uint64_t>> accs(n_acc,
                                            std::vector<uint64_t>(dim, 0));
    std::vector<std::vector<uint8_t>> plains(n_acc);
    // dim+1 slots so an exactly-one-too-long stream decodes cleanly and is
    // reported as a dimension mismatch, not conflated with malformed input
    std::vector<std::vector<int64_t>> rows(n_acc,
                                           std::vector<int64_t>(dim + 1));
    std::atomic<int> err(0);
    std::atomic<size_t> err_index(0);
    const int64_t m = static_cast<int64_t>(modulus);

    run_pool(count, n_threads, [&](size_t tid, size_t i) {
        if (err.load(std::memory_order_relaxed) != 0) return false;
        std::vector<uint8_t>& plain = plains[tid];
        const uint8_t* box = boxes + offs[i];
        size_t blen = offs[i + 1] - offs[i];
        int code = 0;
        if (blen < kSealBytes) {
            code = -2;
        } else {
            plain.resize(blen - kSealBytes);
            if (sda_box_seal_open(plain.data(), box,
                                  static_cast<uint64_t>(blen), pk, sk) != 0) {
                code = -2;
            } else {
                size_t n = sda_varint_decode(plain.data(), plain.size(),
                                             rows[tid].data(), dim + 1);
                if (n == SIZE_MAX) {
                    // bounded decode overflow conflates "well-formed but
                    // longer than dim+1 values" with "malformed"; a
                    // count-only rescan separates them so the caller can
                    // raise the protocol's dimension error vs the codec's
                    // (error path only — never paid by honest jobs)
                    code = sda_varint_count(plain.data(), plain.size()) ==
                                   SIZE_MAX
                               ? -3   // genuinely malformed stream
                               : -4;  // well-formed, wrong share count
                } else if (n != dim) {
                    code = -4;  // wrong share count for this job
                }
            }
        }
        if (code != 0) {
            int expected = 0;
            if (err.compare_exchange_strong(expected, code)) {
                err_index.store(i);
            }
            return false;
        }
        uint64_t* acc = accs[tid].data();
        const int64_t* row = rows[tid].data();
        for (size_t j = 0; j < dim; ++j) {
            int64_t v = row[j];
            if (v < 0) {
                v += m;
                if (v < 0 || v >= m) v = ((v % m) + m) % m;
            } else if (v >= m) {
                v %= m;
            }
            uint64_t a = acc[j] + static_cast<uint64_t>(v);
            if (a >= modulus) a -= modulus;
            acc[j] = a;
        }
        return true;
    });

    if (int e = err.load()) {
        if (fail_index) *fail_index = err_index.load();
        return e;
    }
    for (size_t j = 0; j < dim; ++j) {
        uint64_t a = 0;
        for (size_t t = 0; t < n_acc; ++t) {
            a += accs[t][j];
            if (a >= modulus) a -= modulus;
        }
        combined[j] = static_cast<int64_t>(a);
    }
    return 0;
}

}  // extern "C"
