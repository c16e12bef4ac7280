// Async file I/O for NVMe tiering of the optimizer state (ZeRO-Infinity),
// the PyTorch port's copy of the JAX package's csrc/aio/ds_aio.cpp.
//
// An aio handle with submit/wait semantics backed by a worker thread pool
// doing pread/pwrite, optionally O_DIRECT with aligned buffers.  Blocking
// I/O on a thread pool reaches NVMe's rate at queue_depth x threads for the
// large sequential blocks the optimizer swapper issues.
//
// Plain C ABI for ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Request {
    int op;  // 0 = read, 1 = write
    std::string path;
    void* buffer;
    int64_t nbytes;
    int64_t offset;
};

struct Handle {
    int block_size;
    int queue_depth;
    bool single_submit;
    bool overlap_events;
    int num_threads;
    bool use_direct;

    std::vector<std::thread> workers;
    std::deque<Request> queue;
    std::mutex mu;
    std::condition_variable cv;
    std::condition_variable done_cv;
    std::atomic<int64_t> inflight{0};
    std::atomic<int64_t> errors{0};
    bool stop = false;

    void worker() {
        for (;;) {
            Request req;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [&] { return stop || !queue.empty(); });
                if (stop && queue.empty()) return;
                req = std::move(queue.front());
                queue.pop_front();
            }
            int flags = (req.op == 0) ? O_RDONLY : (O_WRONLY | O_CREAT);
#ifdef O_DIRECT
            if (use_direct) flags |= O_DIRECT;
#endif
            int fd = ::open(req.path.c_str(), flags, 0644);
            bool failed = fd < 0;
            if (!failed) {
                char* p = (char*)req.buffer;
                int64_t left = req.nbytes, off = req.offset;
                while (left > 0) {
                    ssize_t r = (req.op == 0) ? ::pread(fd, p, left, off)
                                              : ::pwrite(fd, p, left, off);
                    if (r <= 0) { failed = true; break; }
                    p += r; off += r; left -= r;
                }
                ::close(fd);
            }
            if (failed) errors.fetch_add(1);
            {
                // The lock orders this decrement with ds_aio_wait's
                // inflight==0 predicate check: without it the waiter can see
                // inflight!=0, the worker then decrements to 0 and notifies
                // before the waiter blocks, and the waiter sleeps forever
                // (lost wakeup).
                std::lock_guard<std::mutex> lk(mu);
                if (inflight.fetch_sub(1) == 1) done_cv.notify_all();
            }
        }
    }
};

}  // namespace

extern "C" {

void* ds_aio_handle_new(int block_size, int queue_depth, int single_submit,
                        int overlap_events, int num_threads, int use_direct) {
    auto* h = new Handle();
    h->block_size = block_size > 0 ? block_size : (1 << 20);
    h->queue_depth = queue_depth > 0 ? queue_depth : 8;
    h->single_submit = single_submit != 0;
    h->overlap_events = overlap_events != 0;
    h->num_threads = num_threads > 0 ? num_threads : 1;
    h->use_direct = use_direct != 0;
    for (int i = 0; i < h->num_threads; ++i)
        h->workers.emplace_back([h] { h->worker(); });
    return h;
}

void ds_aio_handle_free(void* vh) {
    auto* h = (Handle*)vh;
    {
        std::lock_guard<std::mutex> lk(h->mu);
        h->stop = true;
    }
    h->cv.notify_all();
    for (auto& t : h->workers) t.join();
    delete h;
}

// Split [buffer, nbytes) into block_size chunks and enqueue them (async).
static void submit(Handle* h, int op, const char* path, void* buffer,
                   int64_t nbytes, int64_t file_offset) {
    int64_t chunk = h->block_size;
    {
        std::lock_guard<std::mutex> lk(h->mu);
        for (int64_t off = 0; off < nbytes; off += chunk) {
            int64_t len = (off + chunk <= nbytes) ? chunk : (nbytes - off);
            h->inflight.fetch_add(1);
            h->queue.push_back(Request{op, path, (char*)buffer + off, len,
                                       file_offset + off});
        }
    }
    h->cv.notify_all();
}

void ds_aio_pread_async(void* vh, const char* path, void* buffer,
                        int64_t nbytes, int64_t offset) {
    submit((Handle*)vh, 0, path, buffer, nbytes, offset);
}

void ds_aio_pwrite_async(void* vh, const char* path, void* buffer,
                         int64_t nbytes, int64_t offset) {
    submit((Handle*)vh, 1, path, buffer, nbytes, offset);
}

// Block until all submitted requests complete; returns error count since
// the last wait (0 == success).
int64_t ds_aio_wait(void* vh) {
    auto* h = (Handle*)vh;
    std::unique_lock<std::mutex> lk(h->mu);
    h->done_cv.wait(lk, [&] { return h->inflight.load() == 0; });
    return h->errors.exchange(0);
}

// Synchronous convenience (reference: deepspeed_py_aio sync entry points).
int64_t ds_aio_read(void* vh, const char* path, void* buffer, int64_t nbytes,
                    int64_t offset) {
    ds_aio_pread_async(vh, path, buffer, nbytes, offset);
    return ds_aio_wait(vh);
}

int64_t ds_aio_write(void* vh, const char* path, void* buffer, int64_t nbytes,
                     int64_t offset) {
    ds_aio_pwrite_async(vh, path, buffer, nbytes, offset);
    return ds_aio_wait(vh);
}

}  // extern "C"
