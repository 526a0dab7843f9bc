// Multi-threaded writer of the dense pairwise TSV (host code, C++17).
//
// Writes the same bytes as native/'s ks_write_pairwise_tsv: the header, then
// one row per pair a < b with s[a, b] >= max(1, min_shared), in (a, b)
// order, 1-based ids, the shared count, and the min, avg and max
// containment in float32, each printed as printf's "%.6g" of the float
// widened to double.  std::to_chars(double, chars_format::general, 6) is
// specified as that printf form; integers go through integer to_chars.  A
// k-mer count of 0 prints "inf", as the float division gives.
//
// The source rows are cut into blocks of kBlockRows, claimed in order by the
// formatting threads, so the upper triangle's shrinking rows balance.  Each
// thread owns two fixed-size slots: it formats a block into one, hands a
// full slot to the writer (the calling thread) and goes on in the other.
// The writer sends the slots to the file with write(2) strictly in block
// order.  A thread that finds both of its slots unwritten waits: the
// lowest unfinished block never does, so the writer always advances.  All
// slots together hold at most kBufferBytes whatever n.

#include <algorithm>
#include <atomic>
#include <charconv>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <memory>
#include <mutex>
#include <new>
#include <system_error>
#include <thread>
#include <vector>

#include <errno.h>
#include <fcntl.h>
#include <sched.h>
#include <unistd.h>

namespace {

constexpr int64_t kBlockRows = 64;
constexpr int64_t kBufferBytes = int64_t(32) << 20;  // all slots together
constexpr int64_t kSlotBytes = int64_t(1) << 20;     // at most, one slot
constexpr int kMaxThreads = 64;
// room a row needs in its slot: the bounds handed to to_chars below (16, 16,
// 24 and 3 x 24 bytes) and six separators; the longest row (two 10-digit
// ids, a 19-digit count, three "1.17549e-38") is 81 bytes
constexpr int64_t kMaxRowBytes = 160;

constexpr char kHeader[] =
    "source_1\tsource_2\tshared_kmers\tmin_containment\tavg_containment\t"
    "max_containment\n";

enum : int64_t {
    kErrArgs = -1,
    kErrOpen = -2,
    kErrWrite = -3,
    kErrThreads = -4,
    kErrClose = -5,
};

bool write_all(int fd, const char* p, size_t len) {
    while (len > 0) {
        ssize_t r = ::write(fd, p, len);
        if (r < 0 && errno == EINTR) continue;
        if (r <= 0) return false;
        p += r;
        len -= (size_t)r;
    }
    return true;
}

struct Slot {
    char* data = nullptr;
    int64_t len = 0;
    bool last = false;
    bool free = true;
};

struct Writer {
    const int64_t* s;
    int64_t n;
    std::vector<float> kf;  // k-mer counts as float, as the rows divide by
    int64_t min_shared;
    int64_t n_blocks;
    int64_t slot_bytes;

    std::atomic<int64_t> next_block{0};
    std::atomic<int64_t> rows{0};
    std::mutex mu;
    std::condition_variable cv_ready;  // a slot was handed to the writer
    std::condition_variable cv_free;   // a slot was written
    std::vector<Slot> slots;           // thread w owns 2w and 2w + 1
    std::vector<std::deque<int>> ready;  // per thread, in the order handed
    std::vector<int> owner;              // block -> thread, -1 before claimed
    bool failed = false;

    // Wakes every thread waiting for a slot; each then stops.
    void fail() {
        {
            std::lock_guard<std::mutex> lk(mu);
            failed = true;
        }
        cv_free.notify_all();
    }

    int acquire(int w) {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
            return failed || slots[2 * w].free || slots[2 * w + 1].free;
        });
        if (failed) return -1;
        int i = slots[2 * w].free ? 2 * w : 2 * w + 1;
        slots[i].free = false;
        slots[i].len = 0;
        return i;
    }

    void hand(int w, int i, bool last) {
        {
            std::lock_guard<std::mutex> lk(mu);
            slots[i].last = last;
            ready[w].push_back(i);
        }
        cv_ready.notify_one();
    }

    void format(int w) {
        int64_t my_rows = 0;
        for (;;) {
            int64_t blk = next_block.fetch_add(1);
            if (blk >= n_blocks) break;
            {
                std::lock_guard<std::mutex> lk(mu);
                owner[blk] = w;
            }
            int i = acquire(w);
            if (i < 0) return;
            int64_t a_end = std::min(n, (blk + 1) * kBlockRows);
            for (int64_t a = blk * kBlockRows; a < a_end; a++) {
                const int64_t* row = s + a * n;
                const float ka = kf[a];
                for (int64_t b = a + 1; b < n; b++) {
                    const int64_t shared = row[b];
                    if (shared < min_shared) continue;
                    if (slots[i].len + kMaxRowBytes > slot_bytes) {
                        hand(w, i, false);
                        if ((i = acquire(w)) < 0) return;
                    }
                    char* p = slots[i].data + slots[i].len;
                    const float c12 = (float)shared / kf[b];
                    const float c21 = (float)shared / ka;
                    const float cmin = c12 < c21 ? c12 : c21;
                    const float cavg = (float)((c12 + c21) / 2.0);
                    const float cmax = c12 > c21 ? c12 : c21;
                    p = std::to_chars(p, p + 16, a + 1).ptr;
                    *p++ = '\t';
                    p = std::to_chars(p, p + 16, b + 1).ptr;
                    *p++ = '\t';
                    p = std::to_chars(p, p + 24, shared).ptr;
                    for (float v : {cmin, cavg, cmax}) {
                        *p++ = '\t';
                        p = std::to_chars(p, p + 24, (double)v,
                                          std::chars_format::general, 6).ptr;
                    }
                    *p++ = '\n';
                    slots[i].len = p - slots[i].data;
                    my_rows++;
                }
            }
            hand(w, i, true);
        }
        rows.fetch_add(my_rows);
    }

    // Sends the slots to fd in block order; false on a failed write.
    bool drain(int fd, int64_t* bytes) {
        for (int64_t cur = 0; cur < n_blocks;) {
            int i;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_ready.wait(lk, [&] {
                    return owner[cur] >= 0 && !ready[owner[cur]].empty();
                });
                i = ready[owner[cur]].front();
                ready[owner[cur]].pop_front();
            }
            if (!write_all(fd, slots[i].data, (size_t)slots[i].len)) {
                fail();
                return false;
            }
            *bytes += slots[i].len;
            {
                std::lock_guard<std::mutex> lk(mu);
                slots[i].free = true;
                if (slots[i].last) cur++;
            }
            cv_free.notify_all();
        }
        return true;
    }
};

int cpus_allowed() {
    cpu_set_t set;
    if (sched_getaffinity(0, sizeof(set), &set) != 0) return 1;
    return std::max(1, CPU_COUNT(&set));
}

}  // namespace

extern "C" {

// Writes the pairwise TSV of the row-major int64 n x n matrix s to path.
// threads <= 0 takes the CPUs the process may use (at most kMaxThreads);
// slot_bytes <= 0 gives each thread two slots of 1 MiB, or of the 32 MiB
// budget's share where more than 16 threads run.  Returns the rows written
// (and the file's bytes and the formatting threads through the out
// pointers), or a negative code: -1 arguments, -2 open, -3 write, -4 memory
// or threads, -5 close.
int64_t ks_tsv_write_dense(const char* path, const int64_t* s, int64_t n,
                           const int64_t* kmer_counts, int64_t min_shared,
                           int32_t threads, int64_t slot_bytes,
                           int64_t* bytes_out, int32_t* threads_out) {
    if (!path || n < 0 || (n > 0 && (!s || !kmer_counts))) return kErrArgs;
    int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC, 0666);
    if (fd < 0) return kErrOpen;
    int64_t bytes = 0;
    int64_t result = 0;
    int T = 0;
    try {
        Writer wr;
        wr.s = s;
        wr.n = n;
        wr.kf.resize((size_t)n);
        for (int64_t g = 0; g < n; g++) wr.kf[g] = (float)kmer_counts[g];
        wr.min_shared = std::max<int64_t>(1, min_shared);
        wr.n_blocks = (n + kBlockRows - 1) / kBlockRows;
        T = threads > 0 ? threads : cpus_allowed();
        T = (int)std::min<int64_t>({(int64_t)T, (int64_t)kMaxThreads,
                                    std::max<int64_t>(1, wr.n_blocks)});
        wr.slot_bytes = std::max(
            kMaxRowBytes, slot_bytes > 0
                              ? slot_bytes
                              : std::min(kSlotBytes, kBufferBytes / (2 * T)));
        std::unique_ptr<char[]> arena(new char[(size_t)(2 * T * wr.slot_bytes)]);
        wr.slots.resize((size_t)(2 * T));
        for (int i = 0; i < 2 * T; i++)
            wr.slots[i].data = arena.get() + (int64_t)i * wr.slot_bytes;
        wr.ready.resize((size_t)T);
        wr.owner.assign((size_t)wr.n_blocks, -1);

        if (!write_all(fd, kHeader, sizeof(kHeader) - 1)) {
            ::close(fd);
            return kErrWrite;
        }
        bytes = (int64_t)sizeof(kHeader) - 1;
        std::vector<std::thread> pool;
        bool ok;
        try {
            for (int w = 0; w < T; w++) pool.emplace_back(&Writer::format, &wr, w);
            ok = wr.drain(fd, &bytes);
        } catch (const std::system_error&) {
            wr.fail();
            for (auto& t : pool) t.join();
            ::close(fd);
            return kErrThreads;
        }
        for (auto& t : pool) t.join();
        result = ok ? wr.rows.load() : kErrWrite;
    } catch (const std::bad_alloc&) {
        ::close(fd);
        return kErrThreads;
    }
    if (::close(fd) != 0 && result >= 0) result = kErrClose;
    if (bytes_out) *bytes_out = bytes;
    if (threads_out) *threads_out = T;
    return result;
}

}  // extern "C"
