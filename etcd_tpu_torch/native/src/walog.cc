// walog — segmented, CRC-chained, fsync'd append-only record log.
//
// A copy of etcd_tpu/native/src/walog.cc: the record format is the same
// byte for byte, so each package reads the other's WAL directories.
//
// The native core of the WAL (analog of the reference's
// server/storage/wal: wal.go Create/Open/ReadAll/Save/cut/sync,
// encoder/decoder framing, fileutil locking/preallocation). The Python
// facade (etcd_tpu_torch/storage/wal.py) maps raft records onto this layer;
// this file owns everything that touches the filesystem:
//
//  * record framing: [u32 len][u8 type][u8 pad3][u32 crc] + payload,
//    padded to 8 bytes; crc is CRC32C chained across records *and*
//    segment boundaries (each segment opens with a CRC-reset record
//    carrying the running crc, like the reference's crcType records);
//  * segment files "%016llx-%016llx.wal" (seq, meta) preallocated to
//    segment_bytes; cut() rolls to the next seq;
//  * torn-tail recovery: read_all validates the chain and truncates the
//    LAST segment at the first bad/short record; corruption in earlier
//    segments is a hard error;
//  * dir-level advisory lock (flock) so two processes can't own a WAL;
//  * fdatasync with a last-sync-duration gauge for the fsync histogram.
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cerrno>
#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <dirent.h>
#include <fcntl.h>
#include <sys/file.h>
#include <sys/stat.h>
#include <sys/time.h>
#include <ctime>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli, reflected 0x82F63B78), table-driven.
uint32_t kCrcTable[8][256];
bool kCrcInit = false;

void crc_init() {
  if (kCrcInit) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    kCrcTable[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int s = 1; s < 8; s++)
      kCrcTable[s][i] =
          (kCrcTable[s - 1][i] >> 8) ^ kCrcTable[0][kCrcTable[s - 1][i] & 0xFF];
  kCrcInit = true;
}

uint32_t crc32c(uint32_t crc, const uint8_t* p, size_t n) {
  crc ^= 0xFFFFFFFFu;
  // slicing-by-8
  while (n >= 8) {
    uint32_t lo;
    uint32_t hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = kCrcTable[7][lo & 0xFF] ^ kCrcTable[6][(lo >> 8) & 0xFF] ^
          kCrcTable[5][(lo >> 16) & 0xFF] ^ kCrcTable[4][lo >> 24] ^
          kCrcTable[3][hi & 0xFF] ^ kCrcTable[2][(hi >> 8) & 0xFF] ^
          kCrcTable[1][(hi >> 16) & 0xFF] ^ kCrcTable[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = kCrcTable[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
constexpr uint8_t kTypeCrcReset = 0;  // internal: segment-start chain seed
constexpr size_t kHeader = 12;        // u32 len | u8 type | pad3 | u32 crc

uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return uint64_t(ts.tv_sec) * 1000000000ull + uint64_t(ts.tv_nsec);
}

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    snprintf(err, size_t(errlen), "%s", msg.c_str());
  }
}

// A complete-looking record that fails its crc in the tail segment may
// still be a torn write: preallocated segments are zero-filled, so a
// crash between header and payload flush leaves zero sectors inside the
// record region. If any 512-byte disk sector covered by the record is
// all zeros, classify as torn (repairable), else as corruption (ref:
// wal/decoder.go isTornEntry).
bool is_torn_record(const std::vector<uint8_t>& data, size_t off,
                    size_t padded) {
  size_t end = std::min(off + padded, data.size());
  size_t pos = off;
  while (pos < end) {
    size_t piece_end = std::min(((pos / 512) + 1) * 512, end);
    bool all_zero = true;
    for (size_t i = pos; i < piece_end; i++) {
      if (data[i] != 0) {
        all_zero = false;
        break;
      }
    }
    // Ignore sub-8-byte pieces: they can be legitimate record padding.
    if (all_zero && piece_end - pos >= 8) return true;
    pos = piece_end;
  }
  return false;
}

// Make directory entries durable (after create/rename/unlink) — without
// this a crash can lose a whole fdatasync'd segment file (ref:
// fileutil.Fsync on the parent dir in wal cut/create).
void fsync_dir(const std::string& dir) {
  int dfd = open(dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (dfd >= 0) {
    fsync(dfd);
    close(dfd);
  }
}

std::string seg_name(uint64_t seq, uint64_t meta) {
  char buf[64];
  snprintf(buf, sizeof buf, "%016" PRIx64 "-%016" PRIx64 ".wal", seq, meta);
  return buf;
}

bool parse_seg_name(const char* name, uint64_t* seq, uint64_t* meta) {
  size_t len = strlen(name);
  if (len != 16 + 1 + 16 + 4) return false;
  if (strcmp(name + 33, ".wal") != 0 || name[16] != '-') return false;
  char* end = nullptr;
  *seq = strtoull(std::string(name, 16).c_str(), &end, 16);
  *meta = strtoull(std::string(name + 17, 16).c_str(), &end, 16);
  return true;
}

struct Segment {
  uint64_t seq;
  uint64_t meta;  // caller-defined (the Python layer stores a raft index)
  std::string path;
};

int list_segments(const std::string& dir, std::vector<Segment>* out,
                  std::string* errmsg) {
  DIR* d = opendir(dir.c_str());
  if (!d) {
    *errmsg = "opendir " + dir + ": " + strerror(errno);
    return -1;
  }
  out->clear();
  while (struct dirent* de = readdir(d)) {
    uint64_t seq, meta;
    if (parse_seg_name(de->d_name, &seq, &meta))
      out->push_back({seq, meta, dir + "/" + de->d_name});
  }
  closedir(d);
  std::sort(out->begin(), out->end(),
            [](const Segment& a, const Segment& b) { return a.seq < b.seq; });
  for (size_t i = 0; i + 1 < out->size(); i++) {
    if ((*out)[i].seq + 1 != (*out)[i + 1].seq) {
      *errmsg = "wal segments not sequential at seq " +
                std::to_string((*out)[i].seq);
      return -1;
    }
  }
  return 0;
}

struct Walog {
  std::string dir;
  uint64_t segment_bytes;
  int lock_fd = -1;
  int fd = -1;          // current (tail) segment
  uint64_t seq = 0;     // current segment seq
  uint64_t offset = 0;  // write offset in current segment
  uint32_t crc = 0;     // running chain crc
  uint64_t last_sync_ns = 0;
  uint64_t total_syncs = 0;
  uint64_t total_sync_ns = 0;
  std::vector<uint8_t> buf;  // pending (unflushed) bytes
  std::string err;
};

int write_all(int fd, const uint8_t* p, size_t n) {
  while (n > 0) {
    ssize_t w = write(fd, p, n);
    if (w < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    p += w;
    n -= size_t(w);
  }
  return 0;
}

// Append one framed record to w->buf (not yet written to the fd).
void frame_record(Walog* w, uint8_t type, const uint8_t* data, uint64_t len) {
  w->crc = crc32c(w->crc, data, size_t(len));
  uint8_t hdr[kHeader] = {0};
  uint32_t len32 = uint32_t(len);
  memcpy(hdr, &len32, 4);
  hdr[4] = type;
  memcpy(hdr + 8, &w->crc, 4);
  w->buf.insert(w->buf.end(), hdr, hdr + kHeader);
  w->buf.insert(w->buf.end(), data, data + len);
  size_t pad = (8 - ((kHeader + len) & 7)) & 7;
  w->buf.insert(w->buf.end(), pad, 0);
}

int flush_buf(Walog* w) {
  if (w->buf.empty()) return 0;
  if (write_all(w->fd, w->buf.data(), w->buf.size()) != 0) {
    w->err = std::string("write: ") + strerror(errno);
    return -1;
  }
  w->offset += w->buf.size();
  w->buf.clear();
  return 0;
}

// Open a fresh segment file `seq` and seed it with a CRC-reset record.
int open_segment(Walog* w, uint64_t seq, uint64_t meta) {
  std::string tmp = w->dir + "/." + seg_name(seq, meta) + ".tmp";
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0600);
  if (fd < 0) {
    w->err = "create " + tmp + ": " + strerror(errno);
    return -1;
  }
  // Preallocate so appends don't grow file metadata on every sync
  // (ref: fileutil.Preallocate, wal.go cut path).
  if (w->segment_bytes > 0) {
    if (posix_fallocate(fd, 0, off_t(w->segment_bytes)) != 0) {
      // Not fatal: some filesystems don't support it.
    }
    if (ftruncate(fd, 0) != 0) { /* keep blocks, zero length */
    }
  }
  std::string path = w->dir + "/" + seg_name(seq, meta);
  if (rename(tmp.c_str(), path.c_str()) != 0) {
    w->err = "rename " + path + ": " + strerror(errno);
    close(fd);
    return -1;
  }
  fsync_dir(w->dir);
  if (w->fd >= 0) {
    // Durable hand-off: sync the previous tail before switching.
    fdatasync(w->fd);
    close(w->fd);
  }
  w->fd = fd;
  w->seq = seq;
  w->offset = 0;
  // Chain seed record: payload is empty; stored crc = running crc.
  frame_record(w, kTypeCrcReset, nullptr, 0);
  if (flush_buf(w) != 0) return -1;
  return 0;
}

}  // namespace

extern "C" {

typedef void (*walog_rec_cb)(void* ctx, int type, const uint8_t* data,
                             uint64_t len, uint64_t seg_seq, uint64_t seg_meta);

// Create a new WAL dir (must not already contain segments) or open the
// existing one positioned for appends at the tail. Returns NULL on error.
void* walog_open(const char* dir_c, uint64_t segment_bytes, int create,
                 char* err, int errlen) {
  crc_init();
  auto* w = new Walog();
  w->dir = dir_c;
  w->segment_bytes = segment_bytes;

  if (create) {
    if (mkdir(dir_c, 0700) != 0 && errno != EEXIST) {
      set_err(err, errlen, std::string("mkdir: ") + strerror(errno));
      delete w;
      return nullptr;
    }
  }
  std::string lock_path = w->dir + "/wal.lock";
  w->lock_fd = open(lock_path.c_str(), O_WRONLY | O_CREAT, 0600);
  if (w->lock_fd < 0 || flock(w->lock_fd, LOCK_EX | LOCK_NB) != 0) {
    set_err(err, errlen, "wal dir locked by another process");
    if (w->lock_fd >= 0) close(w->lock_fd);
    delete w;
    return nullptr;
  }

  std::vector<Segment> segs;
  std::string emsg;
  if (list_segments(w->dir, &segs, &emsg) != 0) {
    set_err(err, errlen, emsg);
    close(w->lock_fd);
    delete w;
    return nullptr;
  }
  if (create) {
    if (!segs.empty()) {
      set_err(err, errlen, "wal dir not empty");
      close(w->lock_fd);
      delete w;
      return nullptr;
    }
    if (open_segment(w, 0, 0) != 0) {
      set_err(err, errlen, w->err);
      close(w->lock_fd);
      delete w;
      return nullptr;
    }
    return w;
  }
  if (segs.empty()) {
    set_err(err, errlen, "no wal segments");
    close(w->lock_fd);
    delete w;
    return nullptr;
  }
  // Position at the tail: replay the last segment's chain to recover the
  // running crc and append offset (read_all has already truncated torn
  // tails if the caller ran it first — we re-validate here regardless).
  const Segment& tail = segs.back();
  int fd = open(tail.path.c_str(), O_RDWR);
  if (fd < 0) {
    set_err(err, errlen, std::string("open tail: ") + strerror(errno));
    close(w->lock_fd);
    delete w;
    return nullptr;
  }
  struct stat st;
  fstat(fd, &st);
  std::vector<uint8_t> data(size_t(st.st_size));
  ssize_t rd = pread(fd, data.data(), data.size(), 0);
  if (rd < 0) {
    set_err(err, errlen, std::string("pread: ") + strerror(errno));
    close(fd);
    close(w->lock_fd);
    delete w;
    return nullptr;
  }
  data.resize(size_t(rd));
  // Recover the chain crc entering this segment from its seed record.
  // A record running past EOF is a torn tail (truncate); a COMPLETE
  // record failing its crc is corruption (refuse to open — see the
  // rationale in walog_read_all).
  size_t off = 0;
  uint32_t crc = 0;
  bool first = true;
  bool corrupt = false;
  size_t good = 0;
  while (off + kHeader <= data.size()) {
    uint32_t len32, rcrc;
    memcpy(&len32, &data[off], 4);
    uint8_t type = data[off + 4];
    memcpy(&rcrc, &data[off + 8], 4);
    size_t total = kHeader + len32;
    size_t padded = (total + 7) & ~size_t(7);
    if (off + padded > data.size()) break;  // torn tail
    if (first) {
      if (type != kTypeCrcReset) {
        corrupt = true;
        break;
      }
      crc = rcrc;  // seed
      first = false;
    } else {
      uint32_t want = crc32c(crc, &data[off + kHeader], len32);
      if (want != rcrc) {
        if (is_torn_record(data, off, padded))
          break;  // torn: truncate below
        corrupt = true;
        break;
      }
      crc = want;
    }
    off += padded;
    good = off;
  }
  if (good == 0 || corrupt) {
    set_err(err, errlen, corrupt
                             ? "corruption in tail segment " + tail.path
                             : "tail segment has no valid seed record");
    close(fd);
    close(w->lock_fd);
    delete w;
    return nullptr;
  }
  if (good < data.size()) {
    if (ftruncate(fd, off_t(good)) != 0) {
      set_err(err, errlen, std::string("truncate tail: ") + strerror(errno));
      close(fd);
      close(w->lock_fd);
      delete w;
      return nullptr;
    }
  }
  lseek(fd, off_t(good), SEEK_SET);
  w->fd = fd;
  w->seq = tail.seq;
  w->offset = good;
  w->crc = crc;
  return w;
}

const char* walog_errmsg(void* wp) { return static_cast<Walog*>(wp)->err.c_str(); }

int walog_append(void* wp, int type, const uint8_t* data, uint64_t len) {
  auto* w = static_cast<Walog*>(wp);
  if (type <= 0 || type > 255) {
    w->err = "record type must be 1..255";
    return -1;
  }
  frame_record(w, uint8_t(type), data, len);
  return 0;
}

// Flush buffered records to the fd; optionally fdatasync. Returns bytes
// in the tail segment, or -1.
int64_t walog_flush(void* wp, int sync) {
  auto* w = static_cast<Walog*>(wp);
  if (flush_buf(w) != 0) return -1;
  if (sync) {
    uint64_t t0 = now_ns();
    if (fdatasync(w->fd) != 0) {
      w->err = std::string("fdatasync: ") + strerror(errno);
      return -1;
    }
    w->last_sync_ns = now_ns() - t0;
    w->total_syncs++;
    w->total_sync_ns += w->last_sync_ns;
  }
  return int64_t(w->offset);
}

// Roll to a new segment whose name carries `meta` (the Python layer
// passes last_index+1). Implies flush+sync of the old tail.
int walog_cut(void* wp, uint64_t meta) {
  auto* w = static_cast<Walog*>(wp);
  if (flush_buf(w) != 0) return -1;
  return open_segment(w, w->seq + 1, meta);
}

uint64_t walog_tail_offset(void* wp) { return static_cast<Walog*>(wp)->offset; }
uint64_t walog_tail_seq(void* wp) { return static_cast<Walog*>(wp)->seq; }
uint64_t walog_last_sync_ns(void* wp) { return static_cast<Walog*>(wp)->last_sync_ns; }
uint64_t walog_total_syncs(void* wp) { return static_cast<Walog*>(wp)->total_syncs; }
uint64_t walog_total_sync_ns(void* wp) { return static_cast<Walog*>(wp)->total_sync_ns; }

// Delete segments strictly older than the one containing `meta`
// boundaries: keep the newest segment whose meta <= given meta, drop all
// before it (ref: wal.ReleaseLockTo semantics over file locks — here we
// reclaim space directly).
int walog_release_before(void* wp, uint64_t meta) {
  auto* w = static_cast<Walog*>(wp);
  std::vector<Segment> segs;
  std::string emsg;
  if (list_segments(w->dir, &segs, &emsg) != 0) {
    w->err = emsg;
    return -1;
  }
  // Find the last segment with seg.meta <= meta; everything before it
  // can go.
  size_t keep_from = 0;
  for (size_t i = 0; i < segs.size(); i++)
    if (segs[i].meta <= meta) keep_from = i;
  for (size_t i = 0; i < keep_from; i++) unlink(segs[i].path.c_str());
  if (keep_from > 0) fsync_dir(w->dir);
  return int(keep_from);
}

// Classify the shape of the LAST segment's tail WITHOUT repairing —
// the protocol-aware recovery detector (ref: "Protocol-Aware Recovery
// for Consensus-Based Storage", FAST'18: lost durable data must be
// treated as a distinct fault, not silently truncated away). Call
// BEFORE walog_read_all(repair=1): repair truncates the evidence.
//
// Return codes (keep in sync with walog.py TAIL_*):
//   0 = clean: the segment ends exactly at a record boundary with a
//       valid chain — either nothing was being written at the crash,
//       or fsync'd whole records were sheared off at a boundary (which
//       only a higher-level durability watermark can detect);
//   1 = torn: the tail ends INSIDE a record — a header or payload
//       running past EOF, a zero-sector torn write, or sub-header
//       garbage. Bytes beyond the last whole record are gone;
//   2 = corrupt: a complete record fails its crc (non-repairable;
//       walog_read_all refuses these too);
//  <0 = error (err filled in).
int walog_tail_state(const char* dir_c, char* err, int errlen) {
  crc_init();
  std::vector<Segment> segs;
  std::string emsg;
  if (list_segments(dir_c, &segs, &emsg) != 0) {
    set_err(err, errlen, emsg);
    return -1;
  }
  if (segs.empty()) {
    set_err(err, errlen, "no wal segments");
    return -1;
  }
  const Segment& tail = segs.back();
  int fd = open(tail.path.c_str(), O_RDONLY);
  if (fd < 0) {
    set_err(err, errlen, "open " + tail.path + ": " + strerror(errno));
    return -1;
  }
  struct stat st;
  fstat(fd, &st);
  std::vector<uint8_t> data(size_t(st.st_size));
  ssize_t rd = pread(fd, data.data(), data.size(), 0);
  close(fd);
  if (rd < 0) {
    set_err(err, errlen, std::string("pread: ") + strerror(errno));
    return -1;
  }
  data.resize(size_t(rd));
  // Validate the segment standalone: the seed record carries the chain
  // crc entering this segment, so the per-record checks need no
  // earlier segments.
  size_t off = 0;
  uint32_t crc = 0;
  bool first = true;
  while (off + kHeader <= data.size()) {
    uint32_t len32, rcrc;
    memcpy(&len32, &data[off], 4);
    uint8_t type = data[off + 4];
    memcpy(&rcrc, &data[off + 8], 4);
    size_t total = kHeader + len32;
    size_t padded = (total + 7) & ~size_t(7);
    if (off + padded > data.size()) return 1;  // record past EOF: torn
    if (first) {
      if (type != kTypeCrcReset) return 2;
      crc = rcrc;
      first = false;
    } else {
      uint32_t want = crc32c(crc, &data[off + kHeader], len32);
      if (want != rcrc) return is_torn_record(data, off, padded) ? 1 : 2;
      crc = want;
    }
    off += padded;
  }
  if (off < data.size()) return 1;  // sub-header tail garbage: torn
  if (first) return 1;  // no complete seed record survived
  return 0;
}

// Stream every record of every segment (in order) through cb, after
// validating the crc chain. Torn tails in the LAST segment are truncated
// (repair=1) or reported as the stop point; corruption elsewhere is an
// error. Standalone — does not require an open handle (used by Verify
// and by ReadAll-before-open).
int walog_read_all(const char* dir_c, int repair, walog_rec_cb cb, void* ctx,
                   char* err, int errlen) {
  crc_init();
  std::vector<Segment> segs;
  std::string emsg;
  if (list_segments(dir_c, &segs, &emsg) != 0) {
    set_err(err, errlen, emsg);
    return -1;
  }
  uint32_t crc = 0;
  bool chain_started = false;
  for (size_t si = 0; si < segs.size(); si++) {
    const bool last = si + 1 == segs.size();
    int fd = open(segs[si].path.c_str(), repair && last ? O_RDWR : O_RDONLY);
    if (fd < 0) {
      set_err(err, errlen, "open " + segs[si].path + ": " + strerror(errno));
      return -1;
    }
    struct stat st;
    fstat(fd, &st);
    std::vector<uint8_t> data(size_t(st.st_size));
    ssize_t rd = pread(fd, data.data(), data.size(), 0);
    if (rd < 0) {
      set_err(err, errlen, std::string("pread: ") + strerror(errno));
      close(fd);
      return -1;
    }
    data.resize(size_t(rd));
    size_t off = 0, good = 0;
    bool torn = false;     // record runs past EOF — normal after a crash
    bool corrupt = false;  // complete record fails its crc — real damage
    bool first = true;
    while (off + kHeader <= data.size()) {
      uint32_t len32, rcrc;
      memcpy(&len32, &data[off], 4);
      uint8_t type = data[off + 4];
      memcpy(&rcrc, &data[off + 8], 4);
      size_t total = kHeader + len32;
      size_t padded = (total + 7) & ~size_t(7);
      if (off + padded > data.size()) {
        torn = true;
        break;
      }
      if (first) {
        if (type != kTypeCrcReset) {
          corrupt = true;
          break;
        }
        if (!chain_started) {
          crc = rcrc;  // very first segment seeds the chain
          chain_started = true;
        } else if (rcrc != crc) {
          corrupt = true;  // chain mismatch across segment boundary
          break;
        }
        first = false;
      } else {
        uint32_t want = crc32c(crc, &data[off + kHeader], len32);
        if (want != rcrc) {
          if (is_torn_record(data, off, padded))
            torn = true;
          else
            corrupt = true;
          break;
        }
        crc = want;
        if (cb) cb(ctx, type, &data[off + kHeader], len32, segs[si].seq,
                   segs[si].meta);
      }
      off += padded;
      good = off;
    }
    if (off < data.size() && !corrupt) torn = true;  // sub-header tail garbage
    if (torn || corrupt) {
      if (!last || corrupt) {
        // Non-tail damage is always fatal, and so is a failed crc on a
        // COMPLETE record anywhere — those bytes were acknowledged as
        // durable, so auto-truncating them would silently drop
        // fsync'd raft entries. Only a torn tail (record running past
        // EOF — a crash mid-write) is benign and repairable (ref:
        // wal.Repair handling only io.ErrUnexpectedEOF).
        set_err(err, errlen, "corruption in segment " + segs[si].path);
        close(fd);
        return -1;
      }
      if (repair) {
        if (ftruncate(fd, off_t(good)) != 0) {
          set_err(err, errlen,
                  std::string("truncate tail: ") + strerror(errno));
          close(fd);
          return -1;
        }
        fdatasync(fd);
      }
    }
    close(fd);
  }
  return int(segs.size());
}

void walog_close(void* wp) {
  auto* w = static_cast<Walog*>(wp);
  if (w->fd >= 0) {
    flush_buf(w);
    fdatasync(w->fd);
    close(w->fd);
  }
  if (w->lock_fd >= 0) {
    flock(w->lock_fd, LOCK_UN);
    close(w->lock_fd);
  }
  delete w;
}

}  // extern "C"
