// Native dataset loader: a streaming .rs/.pose reader on a worker thread,
// exposed to Python via ctypes (see native/__init__.py).
//
// Role: the reference does dataset IO on a background std::async thread
// (train-cnn.cpp:61, 126-138) because decode and copy stall the training
// loop.  This loader streams frames from any number of recordings into a
// bounded ring of host batches on a worker thread; Python drains complete
// batches with one copy into its NumPy arrays.
//
// Build (native/__init__.py does it at first use, into build/ at the
// repository root):
//   c++ -O3 -shared -fPIC -std=c++17 -pthread loader.cpp -o libhts_loader_<hash>.so
//
// C ABI (all functions return 0 on success, negative errno-style on error):
//   hts_open(paths, n, w, h, batch, capacity) -> handle
//   hts_next_batch(handle, u16* depth_out, f32* pose_out, i32* frame_ids)
//         -> number of frames written (blocks until a batch is ready)
//   hts_total_frames(handle)
//   hts_close(handle)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Recording {
    std::string base;
    int64_t frames = 0;
    size_t frame_px = 0;
    bool has_pose = false;
};

struct Batch {
    std::vector<uint16_t> depth;
    std::vector<float> pose;
    std::vector<int32_t> ids;
    int count = 0;
};

struct Loader {
    int w = 0, h = 0, batch = 0, bones = 17;
    std::vector<Recording> recs;
    std::vector<std::vector<float>> poses;  // per recording, frames*17*7
    int64_t total = 0;

    std::deque<std::unique_ptr<Batch>> ready;
    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    size_t capacity = 4;
    std::atomic<bool> done{false}, stop{false};
    std::thread worker;

    ~Loader() {
        stop = true;
        cv_space.notify_all();
        cv_ready.notify_all();
        if (worker.joinable()) worker.join();
    }

    void run() {
        auto batch_buf = std::make_unique<Batch>();
        auto flush = [&](bool final_flush) {
            if (!batch_buf->count && !final_flush) return true;
            std::unique_lock<std::mutex> lk(mu);
            cv_space.wait(lk, [&] { return ready.size() < capacity || stop; });
            if (stop) return false;
            if (batch_buf->count) {
                ready.push_back(std::move(batch_buf));
                batch_buf = std::make_unique<Batch>();
                cv_ready.notify_one();
            }
            return true;
        };
        size_t frame_px = (size_t)w * h;
        int32_t gid = 0;
        for (size_t r = 0; r < recs.size() && !stop; r++) {
            std::ifstream f(recs[r].base + ".rs", std::ios::binary);
            if (!f.is_open()) continue;
            for (int64_t k = 0; k < recs[r].frames && !stop; k++) {
                if (batch_buf->count == 0) {
                    batch_buf->depth.resize(frame_px * batch);
                    batch_buf->pose.assign((size_t)batch * bones * 7, 0.f);
                    batch_buf->ids.assign(batch, -1);
                }
                int i = batch_buf->count;
                f.read((char *)(batch_buf->depth.data() + frame_px * i),
                       frame_px * 2);
                if (!f) break;
                if (recs[r].has_pose && (size_t)k * bones * 7 < poses[r].size())
                    memcpy(batch_buf->pose.data() + (size_t)i * bones * 7,
                           poses[r].data() + (size_t)k * bones * 7,
                           bones * 7 * sizeof(float));
                batch_buf->ids[i] = gid++;
                batch_buf->count++;
                if (batch_buf->count == batch && !flush(false)) return;
            }
        }
        flush(true);
        done = true;
        cv_ready.notify_all();
    }
};

}  // namespace

extern "C" {

void *hts_open(const char **paths, int n, int w, int h, int batch,
               int capacity) {
    auto *L = new Loader();
    L->w = w;
    L->h = h;
    L->batch = batch;
    L->capacity = capacity > 0 ? capacity : 4;
    size_t frame_px = (size_t)w * h;
    for (int i = 0; i < n; i++) {
        Recording rec;
        rec.base = paths[i];
        std::ifstream f(rec.base + ".rs",
                        std::ios::binary | std::ios::ate);
        if (!f.is_open()) continue;
        rec.frames = (int64_t)f.tellg() / (frame_px * 2);
        rec.frame_px = frame_px;
        std::vector<float> pv;
        std::ifstream pf(rec.base + ".pose");
        if (pf.is_open()) {
            float v;
            while (pf >> v) pv.push_back(v);
            rec.has_pose = pv.size() >= (size_t)L->bones * 7;
        }
        L->poses.push_back(std::move(pv));
        L->total += rec.frames;
        L->recs.push_back(std::move(rec));
    }
    L->worker = std::thread([L] { L->run(); });
    return L;
}

int64_t hts_total_frames(void *h) { return ((Loader *)h)->total; }

int hts_next_batch(void *h, uint16_t *depth_out, float *pose_out,
                   int32_t *ids_out) {
    auto *L = (Loader *)h;
    std::unique_ptr<Batch> b;
    {
        std::unique_lock<std::mutex> lk(L->mu);
        L->cv_ready.wait(lk, [&] {
            return !L->ready.empty() || L->done || L->stop;
        });
        if (L->ready.empty()) return 0;  // end of stream
        b = std::move(L->ready.front());
        L->ready.pop_front();
        L->cv_space.notify_one();
    }
    size_t frame_px = (size_t)L->w * L->h;
    memcpy(depth_out, b->depth.data(), frame_px * 2 * b->count);
    memcpy(pose_out, b->pose.data(),
           (size_t)b->count * L->bones * 7 * sizeof(float));
    memcpy(ids_out, b->ids.data(), sizeof(int32_t) * b->count);
    return b->count;
}

void hts_close(void *h) { delete (Loader *)h; }

}  // extern "C"
