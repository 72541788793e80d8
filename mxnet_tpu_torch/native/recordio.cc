// Native RecordIO reader/writer of mxnet_tpu_torch.
//
// The same byte format as the JAX package's native reader
// (src/native/recordio.cc) and the reference's dmlc-core recordio:
//   [kMagic:u32][lrec:u32][payload][pad to 4B]
//   cflag = lrec >> 29, length = lrec & ((1u<<29)-1)
//   cflag: 0 = whole record, 1 = first chunk, 2 = middle, 3 = last
// A multi-chunk record is read back as its chunks' payloads joined, the
// follow-on chunks' 8-byte headers stripped; the writer writes every
// record as one chunk (cflag 0), as the JAX package's does.
//
// Built with g++ at first use by mxnet_tpu_torch/_native.py and bound
// with ctypes (a flat C ABI, no Python headers).
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kLenMask = (1u << 29) - 1;

struct Handle {
  FILE* f;
  bool writable;
};

inline uint32_t pad4(uint32_t n) { return (n + 3u) & ~3u; }

}  // namespace

extern "C" {

void* rio_open(const char* path, int writable) {
  FILE* f = fopen(path, writable ? "wb" : "rb");
  if (!f) return nullptr;
  auto* h = new Handle{f, writable != 0};
  return h;
}

void rio_close(void* vh) {
  if (!vh) return;
  auto* h = static_cast<Handle*>(vh);
  fclose(h->f);
  delete h;
}

// Returns the byte offset the record was written at, or -1 on error.
long long rio_write(void* vh, const char* data, uint64_t len) {
  auto* h = static_cast<Handle*>(vh);
  if (!h->writable) return -1;
  long long pos = ftell(h->f);
  uint32_t magic = kMagic;
  // single-chunk framing (cflag=0); reader handles multi-chunk too
  uint32_t lrec = static_cast<uint32_t>(len & kLenMask);
  if (fwrite(&magic, 4, 1, h->f) != 1) return -1;
  if (fwrite(&lrec, 4, 1, h->f) != 1) return -1;
  if (len && fwrite(data, 1, len, h->f) != len) return -1;
  uint32_t padded = pad4(static_cast<uint32_t>(len));
  static const char zeros[4] = {0, 0, 0, 0};
  if (padded > len && fwrite(zeros, 1, padded - len, h->f) != padded - len)
    return -1;
  return pos;
}

// Reads the next record into a malloc'd buffer (caller frees with
// rio_free). Returns 1 on success, 0 on EOF, -1 on corruption.
int rio_read(void* vh, char** out, uint64_t* out_len) {
  auto* h = static_cast<Handle*>(vh);
  char* buf = nullptr;
  uint64_t total = 0;
  uint32_t cflag = 0;
  bool first = true;
  do {
    uint32_t magic, lrec;
    if (fread(&magic, 4, 1, h->f) != 1) {
      free(buf);
      return first ? 0 : -1;  // clean EOF only at a record boundary
    }
    if (magic != kMagic) { free(buf); return -1; }
    if (fread(&lrec, 4, 1, h->f) != 1) { free(buf); return -1; }
    cflag = lrec >> 29;
    uint32_t len = lrec & kLenMask;
    char* nbuf = static_cast<char*>(realloc(buf, total + len));
    if (!nbuf && total + len) { free(buf); return -1; }
    buf = nbuf;
    if (len && fread(buf + total, 1, len, h->f) != len) {
      free(buf);
      return -1;
    }
    total += len;
    uint32_t skip = pad4(len) - len;
    if (skip) fseek(h->f, skip, SEEK_CUR);
    if (first && cflag == 0) break;   // single-chunk record
    first = false;
  } while (cflag != 3 && cflag != 0);
  *out = buf;
  *out_len = total;
  return 1;
}

int rio_seek(void* vh, uint64_t offset) {
  auto* h = static_cast<Handle*>(vh);
  return fseek(h->f, static_cast<long>(offset), SEEK_SET) == 0 ? 1 : -1;
}

long long rio_tell(void* vh) {
  auto* h = static_cast<Handle*>(vh);
  return ftell(h->f);
}

void rio_free(char* buf) { free(buf); }

}  // extern "C"
