// Native data-loader runtime for deeplearning4j_tpu_torch (the port's own
// copy of deeplearning4j_tpu/runtime/native/dataloader.cpp; the shuffle
// gives the same order for the same seed and epoch).
//
// Role: the host-side ingest hot path: CSV/IDX parsing, shuffling, batch
// gathering, and a threaded prefetch ring buffer that overlaps batch
// assembly with the card's compute — the native sibling of
// AsyncDataSetIterator.java:36's consumer thread.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -pthread dataloader.cpp -o <lib>.so
// (runtime/native_loader.py builds it at first use into build/torch_native/).
// Binding: ctypes. Plain C ABI, no exceptions across the boundary.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CSV parsing: file -> dense float32 matrix (numeric columns only)
// ---------------------------------------------------------------------------

// Returns 0 on success. Caller frees *out with dl4j_free.
int dl4j_csv_read(const char* path, int skip_lines, char delimiter,
                  float** out, int64_t* out_rows, int64_t* out_cols) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(size) + 1);
    if (size > 0 && std::fread(buf.data(), 1, static_cast<size_t>(size), f) !=
                        static_cast<size_t>(size)) {
        std::fclose(f);
        return 2;
    }
    std::fclose(f);
    buf[static_cast<size_t>(size)] = '\0';

    std::vector<float> values;
    values.reserve(1024);
    int64_t rows = 0, cols = -1;
    char* p = buf.data();
    char* end = buf.data() + size;
    int line_no = 0;
    while (p < end) {
        char* line_end = static_cast<char*>(std::memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        if (line_no++ < skip_lines || line_end == p ||
            (line_end == p + 1 && *p == '\r')) {
            p = line_end + 1;
            continue;
        }
        int64_t line_cols = 0;
        char* q = p;
        while (q <= line_end) {
            char* tok_end = q;
            while (tok_end < line_end && *tok_end != delimiter) tok_end++;
            char saved = *tok_end;
            *tok_end = '\0';
            values.push_back(std::strtof(q, nullptr));
            *tok_end = saved;
            line_cols++;
            if (tok_end >= line_end) break;
            q = tok_end + 1;
        }
        if (cols < 0) cols = line_cols;
        else if (line_cols != cols) return 3;  // ragged rows
        rows++;
        p = line_end + 1;
    }
    float* data = static_cast<float*>(std::malloc(sizeof(float) * values.size()));
    if (!data && !values.empty()) return 4;
    std::memcpy(data, values.data(), sizeof(float) * values.size());
    *out = data;
    *out_rows = rows;
    *out_cols = cols < 0 ? 0 : cols;
    return 0;
}

// ---------------------------------------------------------------------------
// IDX (MNIST) reader -> float32, normalized by 'scale' (pass 255 for pixels)
// ---------------------------------------------------------------------------

static uint32_t read_be32(const unsigned char* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int dl4j_idx_read(const char* path, float scale, float** out,
                  int32_t* out_ndim, int64_t* out_dims /* len>=8 */) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    unsigned char header[4];
    if (std::fread(header, 1, 4, f) != 4 || header[0] != 0 || header[1] != 0) {
        std::fclose(f);
        return 2;
    }
    int dtype = header[2];
    int ndim = header[3];
    if (ndim > 8) { std::fclose(f); return 3; }
    int64_t total = 1;
    for (int i = 0; i < ndim; i++) {
        unsigned char d[4];
        if (std::fread(d, 1, 4, f) != 4) { std::fclose(f); return 2; }
        out_dims[i] = read_be32(d);
        total *= out_dims[i];
    }
    if (dtype != 0x08) { std::fclose(f); return 4; }  // ubyte only
    std::vector<unsigned char> raw(static_cast<size_t>(total));
    if (std::fread(raw.data(), 1, raw.size(), f) != raw.size()) {
        std::fclose(f);
        return 2;
    }
    std::fclose(f);
    float* data = static_cast<float*>(std::malloc(sizeof(float) * total));
    if (!data) return 5;
    float inv = scale > 0 ? 1.0f / scale : 1.0f;
    for (int64_t i = 0; i < total; i++) data[i] = raw[i] * inv;
    *out = data;
    *out_ndim = ndim;
    return 0;
}

void dl4j_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Shuffle + batch gather
// ---------------------------------------------------------------------------

void dl4j_shuffled_indices(int64_t n, uint64_t seed, int64_t* out) {
    for (int64_t i = 0; i < n; i++) out[i] = i;
    std::mt19937_64 rng(seed);
    for (int64_t i = n - 1; i > 0; i--) {
        int64_t j = static_cast<int64_t>(rng() % static_cast<uint64_t>(i + 1));
        int64_t t = out[i]; out[i] = out[j]; out[j] = t;
    }
}

void dl4j_gather_rows(const float* src, int64_t cols, const int64_t* indices,
                      int64_t n_idx, float* dst) {
    for (int64_t i = 0; i < n_idx; i++) {
        std::memcpy(dst + i * cols, src + indices[i] * cols,
                    sizeof(float) * cols);
    }
}

// ---------------------------------------------------------------------------
// Threaded prefetching batch loader over in-memory feature/label matrices.
// Worker threads gather shuffled batches into a bounded ring of slots; the
// consumer (Python) pops filled slots. Epoch reshuffles use seed+epoch.
// ---------------------------------------------------------------------------

struct Loader {
    const float* features;  // [n, fcols] borrowed (numpy owns)
    const float* labels;    // [n, lcols]
    int64_t n, fcols, lcols, batch;
    int drop_last;
    uint64_t seed;

    std::vector<int64_t> order;
    int64_t n_batches = 0;

    struct Slot {
        std::vector<float> feat, lab;
        int64_t batch_idx = -1;
        bool full = false;
    };
    std::vector<Slot> slots;
    std::mutex mu;
    std::condition_variable cv_full, cv_empty;
    int64_t next_produce = 0;  // batch index workers claim
    int64_t next_consume = 0;  // batch index consumer expects
    int64_t in_flight = 0;     // claimed but not yet marked full (reset gate)
    std::atomic<bool> stop{false};
    std::vector<std::thread> workers;

    void fill(Slot& slot, int64_t bi) {
        int64_t start = bi * batch;
        int64_t count = std::min(batch, n - start);
        slot.feat.resize(static_cast<size_t>(batch * fcols));
        slot.lab.resize(static_cast<size_t>(batch * lcols));
        for (int64_t i = 0; i < count; i++) {
            int64_t src_row = order[static_cast<size_t>(start + i)];
            std::memcpy(slot.feat.data() + i * fcols,
                        features + src_row * fcols, sizeof(float) * fcols);
            std::memcpy(slot.lab.data() + i * lcols,
                        labels + src_row * lcols, sizeof(float) * lcols);
        }
    }

    void worker_loop() {
        while (true) {
            int64_t bi;
            size_t slot_i;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_empty.wait(lk, [&] {
                    return stop.load() ||
                           (next_produce < n_batches &&
                            next_produce - next_consume <
                                static_cast<int64_t>(slots.size()));
                });
                if (stop.load()) return;
                bi = next_produce++;
                in_flight++;
                slot_i = static_cast<size_t>(bi % slots.size());
            }
            // Slot is guaranteed free: consumer pops in order and bi is at
            // most next_consume + capacity - 1.
            Slot& slot = slots[slot_i];
            fill(slot, bi);
            {
                std::lock_guard<std::mutex> lk(mu);
                slot.batch_idx = bi;  // published under the lock
                slot.full = true;
                in_flight--;
                cv_full.notify_all();
            }
        }
    }
};

void* dl4j_loader_create(const float* features, const float* labels,
                         int64_t n, int64_t fcols, int64_t lcols,
                         int64_t batch, int shuffle, uint64_t seed,
                         int drop_last, int queue_size, int n_workers) {
    Loader* L = new Loader();
    L->features = features; L->labels = labels;
    L->n = n; L->fcols = fcols; L->lcols = lcols; L->batch = batch;
    L->drop_last = drop_last; L->seed = seed;
    L->order.resize(static_cast<size_t>(n));
    if (shuffle) dl4j_shuffled_indices(n, seed, L->order.data());
    else for (int64_t i = 0; i < n; i++) L->order[static_cast<size_t>(i)] = i;
    L->n_batches = drop_last ? n / batch : (n + batch - 1) / batch;
    L->slots.resize(static_cast<size_t>(queue_size > 0 ? queue_size : 4));
    int nw = n_workers > 0 ? n_workers : 1;
    for (int i = 0; i < nw; i++)
        L->workers.emplace_back([L] { L->worker_loop(); });
    return L;
}

int64_t dl4j_loader_num_batches(void* h) {
    return static_cast<Loader*>(h)->n_batches;
}

// Blocks until the next batch (in order) is ready; copies it out.
// Returns rows in the batch (may be < batch for the final partial one),
// 0 when the epoch is exhausted.
int64_t dl4j_loader_next(void* h, float* feat_out, float* lab_out) {
    Loader* L = static_cast<Loader*>(h);
    int64_t bi;
    {
        std::lock_guard<std::mutex> lk(L->mu);
        if (L->next_consume >= L->n_batches) return 0;
        bi = L->next_consume;
    }
    size_t slot_i = static_cast<size_t>(bi % L->slots.size());
    Loader::Slot& slot = L->slots[slot_i];
    {
        std::unique_lock<std::mutex> lk(L->mu);
        L->cv_full.wait(lk, [&] { return slot.full && slot.batch_idx == bi; });
    }
    int64_t start = bi * L->batch;
    int64_t count = std::min(L->batch, L->n - start);
    std::memcpy(feat_out, slot.feat.data(), sizeof(float) * count * L->fcols);
    std::memcpy(lab_out, slot.lab.data(), sizeof(float) * count * L->lcols);
    {
        std::lock_guard<std::mutex> lk(L->mu);
        slot.full = false;
        slot.batch_idx = -1;
        L->next_consume++;
        L->cv_empty.notify_all();
    }
    return count;
}

// Reset for a new epoch; optionally reshuffle with seed+epoch.
void dl4j_loader_reset(void* h, int shuffle, uint64_t epoch) {
    Loader* L = static_cast<Loader*>(h);
    std::unique_lock<std::mutex> lk(L->mu);
    // block new claims, then wait until no worker is mid-fill
    L->next_consume = L->n_batches;
    L->next_produce = L->n_batches;
    L->cv_full.wait(lk, [&] { return L->in_flight == 0; });
    for (auto& s : L->slots) { s.full = false; s.batch_idx = -1; }
    L->next_produce = 0;
    L->next_consume = 0;
    if (shuffle)
        dl4j_shuffled_indices(L->n, L->seed + epoch, L->order.data());
    L->cv_empty.notify_all();
}

void dl4j_loader_destroy(void* h) {
    Loader* L = static_cast<Loader*>(h);
    {
        std::lock_guard<std::mutex> lk(L->mu);
        L->stop.store(true);
        L->cv_empty.notify_all();
    }
    for (auto& t : L->workers) t.join();
    delete L;
}

}  // extern "C"
