// A pool of native threads that read byte ranges of files into memory the
// caller owns, piece by piece, in the order the pieces were handed in.
//
// The corpus scan reads each 16-bit WAV's data chunk here, straight into
// its room of the pinned host ring (syllable_detector_tpu_torch/corpus.py).
// Python threads doing the same reads (os.preadv) take the interpreter lock
// back after every piece, and the calling thread, which enqueues the device
// work between the reads and takes the lock back after every PyTorch call,
// then waits for it behind them; these threads never hold it, so the
// calling thread runs at its own speed while they read (PERF.md).
//
// A read of one file is a job: its data range cut into pieces, each piece
// read by one thread with pread (EINTR retried, a short read continued
// until the file ends). Pieces are taken first in, first out, so a file's
// pieces are taken before any piece of a file handed in after it. The
// caller waits for a job once, which frees it; ctypes releases the
// interpreter lock for the wait.
//
// Exposed as a small C ABI for ctypes binding from Python.

#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <ctime>
#include <deque>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#include <unistd.h>

namespace {

int64_t now_ns() {  // the clock of Python's time.perf_counter_ns on Linux
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return int64_t(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

struct Job {
    int fd;
    char* dst;
    int64_t offset;
    std::vector<std::pair<int64_t, int64_t>> cuts;  // [lo, hi) of the range
    std::vector<int64_t> got;  // a piece's bytes read, or -errno
    size_t started = 0, ended = 0;
    int64_t start_ns = 0, end_ns = 0;
};

struct Pool {
    std::mutex mu;
    std::condition_variable work, done;
    std::deque<std::pair<Job*, size_t>> queue;  // (job, piece), first in, first out
};

int64_t read_piece(const Job& job, size_t k) {
    int64_t lo = job.cuts[k].first, hi = job.cuts[k].second, got = 0;
    while (got < hi - lo) {
        ssize_t n = pread(job.fd, job.dst + lo + got, size_t(hi - lo - got), job.offset + lo + got);
        if (n < 0 && errno == EINTR) continue;
        if (n < 0) return -int64_t(errno);
        if (n == 0) break;  // the file ends first
        got += n;
    }
    return got;
}

void serve(Pool* pool) {
    std::unique_lock<std::mutex> lock(pool->mu);
    for (;;) {
        pool->work.wait(lock, [pool] { return !pool->queue.empty(); });
        auto [job, k] = pool->queue.front();
        pool->queue.pop_front();
        if (job->started++ == 0) job->start_ns = now_ns();
        lock.unlock();
        int64_t got = read_piece(*job, k);
        lock.lock();
        job->got[k] = got;
        if (++job->ended == job->cuts.size()) {
            job->end_ns = now_ns();
            pool->done.notify_all();
        }
    }
}

}  // namespace

extern "C" {

// A pool of `threads` reading threads, which live as long as the process.
void* sdpieces_pool(int32_t threads) {
    Pool* pool = new Pool();
    for (int32_t i = 0; i < threads; ++i) std::thread(serve, pool).detach();
    return pool;
}

// Hand in the read of `length` bytes of `fd` at `offset` into `dst`, cut
// into `npieces` pieces at `bounds` (npieces + 1 offsets into the range,
// from 0 to `length`). Returns the job, for sdpieces_wait.
void* sdpieces_read(void* pool_, int32_t fd, char* dst, int64_t offset, const int64_t* bounds,
                    int32_t npieces) {
    Pool* pool = static_cast<Pool*>(pool_);
    Job* job = new Job();
    job->fd = fd;
    job->dst = dst;
    job->offset = offset;
    for (int32_t k = 0; k < npieces; ++k) job->cuts.emplace_back(bounds[k], bounds[k + 1]);
    job->got.assign(size_t(npieces), 0);
    {
        std::lock_guard<std::mutex> lock(pool->mu);
        for (int32_t k = 0; k < npieces; ++k) pool->queue.emplace_back(job, size_t(k));
    }
    for (int32_t k = 0; k < npieces; ++k) pool->work.notify_one();
    return job;
}

// Wait until every piece of `job` has ended, and free it. `times` gets
// the first piece's start and the last piece's end, in ns. Returns the
// bytes read up to the first short piece, or -errno of the first piece
// that failed.
int64_t sdpieces_wait(void* pool_, void* job_, int64_t* times) {
    Pool* pool = static_cast<Pool*>(pool_);
    Job* job = static_cast<Job*>(job_);
    {
        std::unique_lock<std::mutex> lock(pool->mu);
        pool->done.wait(lock, [job] { return job->ended == job->cuts.size(); });
    }
    times[0] = job->start_ns;
    times[1] = job->end_ns;
    int64_t total = 0;
    for (size_t k = 0; k < job->cuts.size(); ++k) {
        int64_t got = job->got[k];
        if (got < 0) {
            total = got;
            break;
        }
        total += got;
        if (got < job->cuts[k].second - job->cuts[k].first) break;
    }
    delete job;
    return total;
}

}  // extern "C"
