// Multi-threaded writer and reader of the pairwise TSV (host code, C++17).
//
// The writer (ks_tsv_write_dense) writes the same bytes as native/'s
// ks_write_pairwise_tsv: the header, then one row per pair a < b with
// s[a, b] >= max(1, min_shared), in (a, b) order, 1-based ids, the shared
// count, and the min, avg and max containment in float32, each printed as
// printf's "%.6g" of the float widened to double.
// std::to_chars(double, chars_format::general, 6) is specified as that
// printf form; integers go through integer to_chars.  A k-mer count of 0
// prints "inf", as the float division gives.
//
// The source rows are cut into blocks of kBlockRows, claimed in order by the
// formatting threads, so the upper triangle's shrinking rows balance.  Each
// thread owns two fixed-size slots: it formats a block into one, hands a
// full slot to the writer (the calling thread) and goes on in the other.
// The writer sends the slots to the file with write(2) strictly in block
// order.  A thread that finds both of its slots unwritten waits: the
// lowest unfinished block never does, so the writer always advances.  All
// slots together hold at most kBufferBytes whatever n.
//
// The reader (ks_tsv_read_*) streams a pairwise TSV, or the one-column ani
// file, back as int64 ids and double distances in file order; see its
// section below.

#include <algorithm>
#include <atomic>
#include <charconv>
#include <condition_variable>
#include <cstdint>
#include <cstring>
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
#include <sys/stat.h>
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

// ---------------------------------------------------------------------------
// The reader.
//
// A file is read in windows with pread(2), one slice a thread, never mapped,
// so the reader holds one buffer of at most kReadWindowMax bytes whatever the
// file's size: a window is kReadWindowPerThread bytes a thread.  The file is
// in the page cache as a rule (pairwise wrote it), so reading is a copy that
// the threads share.  Each window is cut back to
// its last newline (the rest is carried into the next window) and split at
// newlines into one range a thread.  Pass 1 counts each range's rows; after
// a prefix sum, pass 2 parses each range straight into the caller's arrays at
// its own offset, so the rows come out in file order.  Where a window holds
// more rows than the chunk has room for, it is cut after the last row that
// fits, and the rest is parsed by the next call.
//
// Lines as pandas' C engine reads them with header=0: the first non-blank
// line is the header and is skipped; a line of spaces and carriage returns
// alone is blank and skipped; a line ends at '\n', a '\r' before it is
// dropped, and the last line needs no newline.  Fields are split at tabs.
// Columns 0 and 1 are the int64 ids (integer from_chars) and column
// dist_col the distance (from_chars for double, correctly rounded: the value
// strtod and Python's float() give).  Other columns are skipped unread.  A
// wanted field that is missing, empty, out of range or not wholly a number
// makes the row bad: the call fails and names its line.

namespace {

constexpr int64_t kReadWindowPerThread = int64_t(4) << 20;
constexpr int64_t kReadWindowMax = int64_t(32) << 20;  // one file's buffer
constexpr int64_t kReadWindowMin = 64;
constexpr int64_t kRangeMin = int64_t(64) << 10;  // least bytes worth a thread

enum : int64_t {
    kErrRead = -6,
    kErrRow = -7,
    kErrLongLine = -8,
};

// A part of a window, one thread's: [lo, hi) starts a line and ends after one.
struct Range {
    const char* lo;
    const char* hi;
    int64_t rows = 0;        // lines that are not blank
    int64_t lines = 0;       // all lines
    int64_t first_line = 0;  // the line number of lo
    int64_t out = 0;         // the output index of its first row
    int64_t bad_line = 0;    // the first bad row's line number, 0 if none
};

inline bool is_blank(const char* p, const char* e) {
    for (; p < e; p++)
        if (*p != ' ' && *p != '\r') return false;
    return true;
}

// The '\n' that ends the line starting at p, or hi where none does.
inline const char* line_end(const char* p, const char* hi) {
    const void* nl = std::memchr(p, '\n', (size_t)(hi - p));
    return nl ? (const char*)nl : hi;
}

inline const char* after(const char* e, const char* hi) { return e < hi ? e + 1 : hi; }

// Runs f(0), ..., f(n - 1), f(0) on the calling thread and the others on
// threads of their own (inline where a thread cannot start).
template <class F>
void run_parallel(int n, const F& f) {
    std::vector<std::thread> pool;
    pool.reserve((size_t)n);
    for (int k = 1; k < n; k++) {
        try {
            pool.emplace_back(f, k);
        } catch (const std::system_error&) {
            f(k);
        }
    }
    f(0);
    for (auto& t : pool) t.join();
}

struct Reader {
    int fd = -1;
    int64_t size = 0;      // the file's bytes at open
    int64_t read_off = 0;  // bytes read from the file so far
    std::unique_ptr<char[]> buf;
    int64_t cap = 0;
    int64_t begin = 0, end = 0;  // the unparsed bytes, buf[begin, end)
    int64_t line = 1;            // the line number of buf[begin]
    bool eof = false;
    bool header_done = false;
    bool ids = true;
    int dist_col = -1;
    int last_col = 0;
    int threads = 1;
    int64_t range_min = kRangeMin;

    ~Reader() {
        if (fd >= 0) ::close(fd);
    }

    // Reads bytes [off, off + len) of the file into p; the bytes read (fewer
    // only at the end of the file), or -errno.
    int64_t read_at(char* p, int64_t off, int64_t len) const {
        int64_t got = 0;
        while (got < len) {
            ssize_t r = ::pread(fd, p + got, (size_t)(len - got), (off_t)(off + got));
            if (r < 0 && errno == EINTR) continue;
            if (r < 0) return -errno;
            if (r == 0) break;
            got += r;
        }
        return got;
    }

    // Moves the unparsed bytes to the front and reads until the buffer is
    // full or the file ends, one slice a thread; 0, or the errno of a failed
    // read.
    int fill() {
        if (eof) return 0;
        if (begin > 0) {
            std::memmove(buf.get(), buf.get() + begin, (size_t)(end - begin));
            end -= begin;
            begin = 0;
        }
        const int64_t want = cap - end;
        if (want == 0) return 0;
        const int T = (int)std::max<int64_t>(
            1, std::min<int64_t>(threads, want / range_min));
        std::vector<int64_t> got((size_t)T);
        run_parallel(T, [&](int k) {
            const int64_t lo = want * k / T, hi = want * (k + 1) / T;
            got[k] = read_at(buf.get() + end + lo, read_off + lo, hi - lo);
        });
        // the bytes up to the first short slice; the file ends there
        for (int k = 0; k < T; k++) {
            if (got[k] < 0) return (int)-got[k];
            const int64_t len = want * (k + 1) / T - want * k / T;
            end += got[k];
            read_off += got[k];
            if (got[k] < len) {
                eof = true;
                break;
            }
        }
        return 0;
    }

    // Parses the row [p, e), its newline and '\r' left out.
    bool parse_row(const char* p, const char* e, int64_t& a, int64_t& b,
                   double& d) const {
        for (int c = 0;; c++) {
            const char* f;  // the end of column c's field
            if (ids && c < 2) {
                auto r = std::from_chars(p, e, c == 0 ? a : b);
                if (r.ec != std::errc()) return false;
                f = r.ptr;
            } else if (c == dist_col) {
                auto r = std::from_chars(p, e, d, std::chars_format::general);
                if (r.ec != std::errc()) return false;
                f = r.ptr;
            } else {
                const void* t = std::memchr(p, '\t', (size_t)(e - p));
                f = t ? (const char*)t : e;
            }
            if (f != e && *f != '\t') return false;
            if (c == last_col) return true;
            if (f == e) return false;
            p = f + 1;
        }
    }

    static void count(Range& r) {
        int64_t rows = 0, lines = 0;
        for (const char* p = r.lo; p < r.hi;) {
            const char* e = line_end(p, r.hi);
            lines++;
            rows += !is_blank(p, e);
            p = after(e, r.hi);
        }
        r.rows = rows;
        r.lines = lines;
    }

    // The end of r's first k rows, after the newline of the k-th.
    static const char* after_rows(const Range& r, int64_t k) {
        const char* p = r.lo;
        while (k > 0) {
            const char* e = line_end(p, r.hi);
            k -= !is_blank(p, e);
            p = after(e, r.hi);
        }
        return p;
    }

    void parse(Range& r, int64_t* ids1, int64_t* ids2, double* dist) const {
        int64_t i = r.out, lines = 0;
        int64_t a = 0, b = 0;
        double d = 0;
        for (const char* p = r.lo; p < r.hi;) {
            const char* e = line_end(p, r.hi);
            lines++;
            if (!is_blank(p, e)) {
                const char* s = e > p && e[-1] == '\r' ? e - 1 : e;
                if (!parse_row(p, s, a, b, d)) {
                    r.bad_line = r.first_line + lines - 1;
                    return;
                }
                if (ids) {
                    ids1[i] = a;
                    ids2[i] = b;
                }
                if (dist) dist[i] = d;
                i++;
            }
            p = after(e, r.hi);
        }
        r.lines = lines;
    }

    // Parses up to max_rows rows into the arrays; the rows parsed (0 at the
    // end of the file) or a negative code, with the errno (kErrRead) or the
    // line number (kErrRow, kErrLongLine) in *info.
    int64_t next(int64_t max_rows, int64_t* ids1, int64_t* ids2, double* dist,
                 int64_t* info) {
        int64_t got = 0;
        while (got < max_rows) {
            if (int err = fill()) {
                *info = err;
                return kErrRead;
            }
            if (begin == end) break;
            const char* lo = buf.get() + begin;
            const char* hi = buf.get() + end;
            if (!eof) {  // the buffer is full: cut it after its last newline
                const void* nl = memrchr(lo, '\n', (size_t)(hi - lo));
                if (!nl) {
                    *info = line;
                    return kErrLongLine;
                }
                hi = (const char*)nl + 1;
            }
            if (!header_done) {
                const char* e = line_end(lo, hi);
                header_done = !is_blank(lo, e);
                begin = after(e, hi) - buf.get();
                line++;
                continue;
            }
            const int64_t span = hi - lo;
            const int T = (int)std::max<int64_t>(
                1, std::min<int64_t>(threads, (span + range_min - 1) / range_min));
            std::vector<Range> rg((size_t)T);
            const char* prev = lo;
            for (int k = 0; k < T; k++) {
                const char* x = k + 1 == T ? hi : lo + span * (k + 1) / T;
                if (x < prev) x = prev;
                if (x > prev && x < hi && x[-1] != '\n') x = after(line_end(x, hi), hi);
                rg[k].lo = prev;
                rg[k].hi = x;
                prev = x;
            }
            run_parallel(T, [&rg](int k) { count(rg[k]); });

            // offsets and line numbers; the range that fills the chunk is cut
            // after its last row that fits, and the ranges after it wait
            const int64_t need = max_rows - got;
            int64_t taken = 0, ln = line;
            int active = T;
            for (int k = 0; k < T; k++) {
                rg[k].out = got + taken;
                rg[k].first_line = ln;
                if (taken + rg[k].rows >= need) {
                    if (taken + rg[k].rows > need)
                        rg[k].hi = after_rows(rg[k], need - taken);
                    taken = need;
                    active = k + 1;
                    break;
                }
                taken += rg[k].rows;
                ln += rg[k].lines;
            }
            run_parallel(active, [&](int k) { parse(rg[k], ids1, ids2, dist); });
            for (int k = 0; k < active; k++) {
                if (rg[k].bad_line) {
                    *info = rg[k].bad_line;
                    return kErrRow;
                }
                line += rg[k].lines;
            }
            got += taken;
            begin = rg[active - 1].hi - buf.get();
        }
        return got;
    }
};

}  // namespace

extern "C" {

// Opens path for reading: ids != 0 parses columns 0 and 1 as int64 ids,
// dist_col >= 0 parses that column as a double (not 0 or 1 with ids).
// threads <= 0 takes the CPUs the process may use (at most kMaxThreads);
// window_bytes <= 0 takes kReadWindowPerThread a thread, and any window is
// held to [kReadWindowMin, kReadWindowMax] and to the file's size.  Returns
// the handle (and the threads, the window's bytes and the file's bytes
// through the out pointers), or null: *errno_out is then the errno of a
// failed open, or 0 for bad arguments or no memory.
void* ks_tsv_read_open(const char* path, int32_t ids, int32_t dist_col,
                       int32_t threads, int64_t window_bytes,
                       int32_t* threads_out, int64_t* window_out,
                       int64_t* size_out, int32_t* errno_out) {
    *errno_out = 0;
    if (!path || dist_col < -1 || (!ids && dist_col < 0) ||
        (ids && (dist_col == 0 || dist_col == 1)))
        return nullptr;
    try {
        std::unique_ptr<Reader> r(new Reader);
        r->fd = ::open(path, O_RDONLY | O_CLOEXEC);
        struct stat st;
        if (r->fd < 0 || ::fstat(r->fd, &st) != 0) {
            *errno_out = errno;
            return nullptr;
        }
        r->size = (int64_t)st.st_size;
        r->ids = ids != 0;
        r->dist_col = dist_col;
        r->last_col = std::max(ids ? 1 : 0, (int)dist_col);
        r->threads = std::min(threads > 0 ? (int)threads : cpus_allowed(), kMaxThreads);
        int64_t window = window_bytes > 0 ? window_bytes
                                          : r->threads * kReadWindowPerThread;
        window = std::max(kReadWindowMin, std::min(kReadWindowMax, window));
        r->range_min = std::min(kRangeMin, std::max<int64_t>(1, window / r->threads));
        r->cap = std::min(window, std::max(kReadWindowMin, r->size + 1));
        r->buf.reset(new char[(size_t)r->cap]);
        *threads_out = r->threads;
        *window_out = r->cap;
        *size_out = r->size;
        return r.release();
    } catch (const std::bad_alloc&) {
        return nullptr;
    }
}

// The bytes of the file not yet parsed: no more rows than this allows remain.
int64_t ks_tsv_read_left(void* handle) {
    const Reader* r = (const Reader*)handle;
    return std::max<int64_t>(0, r->size - r->read_off) + (r->end - r->begin);
}

// Parses the next rows, up to max_rows, into ids1 and ids2 (with ids) and
// dist (with a dist_col), in file order.  Returns the rows parsed, fewer than
// max_rows only at the end of the file, or a negative code: -1 arguments, -4
// memory, -6 read (*info the errno), -7 a bad row, -8 a line longer than the
// window (*info the line number).
int64_t ks_tsv_read_next(void* handle, int64_t max_rows, int64_t* ids1,
                         int64_t* ids2, double* dist, int64_t* info) {
    Reader* r = (Reader*)handle;
    if (!r || max_rows < 0 || (r->ids && (!ids1 || !ids2)) ||
        (r->dist_col >= 0 && !dist))
        return kErrArgs;
    try {
        return r->next(max_rows, ids1, ids2, r->dist_col >= 0 ? dist : nullptr, info);
    } catch (const std::bad_alloc&) {
        return kErrThreads;
    }
}

void ks_tsv_read_close(void* handle) { delete (Reader*)handle; }

}  // extern "C"
