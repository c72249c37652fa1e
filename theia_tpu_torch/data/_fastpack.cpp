// Native tar-header walker for the port's shard index (data/webdataset.py
// ShardIndex): one C loop over the 512-byte headers of a whole mapped shard
// in place of one Python TarInfo a member. ustar/GNU format, as Python's
// tarfile and the reference's webdataset shards write it. Host code: it
// imports nothing and runs on the CPU.
//
// Build: g++ -O3 -shared -fPIC -o libfastpack_<hash>.so _fastpack.cpp
// (done at first use by theia_tpu_torch/data/fastpack.py).

#include <cstdint>

extern "C" {

// Walk tar headers in `buf` (whole shard, mmap'd). For each regular file
// member, write (header_offset, data_offset, size) into `out` (3 int64 per
// member, capacity `cap` members). Returns member count, or -1 on a
// malformed header, or -(needed) if cap is too small.
int64_t fp_tar_index(const char* buf, int64_t len, int64_t* out, int64_t cap) {
  int64_t pos = 0, count = 0;
  while (pos + 512 <= len) {
    const char* hdr = buf + pos;
    bool empty = true;
    for (int i = 0; i < 512; ++i)
      if (hdr[i] != 0) { empty = false; break; }
    if (empty) break;  // end-of-archive blocks
    // size field: octal at offset 124, 12 bytes (or base-256 GNU extension)
    int64_t size = 0;
    const unsigned char* sz = (const unsigned char*)hdr + 124;
    if (sz[0] & 0x80) {
      for (int i = 1; i < 12; ++i) size = (size << 8) | sz[i];
    } else {
      for (int i = 0; i < 12; ++i) {
        unsigned char c = sz[i];
        if (c == ' ' || c == 0) continue;
        if (c < '0' || c > '7') return -1;
        size = size * 8 + (c - '0');
      }
    }
    char typeflag = hdr[156];
    int64_t data = pos + 512;
    int64_t padded = (size + 511) & ~int64_t(511);
    if (typeflag == '0' || typeflag == 0) {  // regular file
      if (count >= cap) return -(count + 1);
      out[count * 3 + 0] = pos;
      out[count * 3 + 1] = data;
      out[count * 3 + 2] = size;
      ++count;
    }
    pos = data + padded;
  }
  return count;
}

}  // extern "C"
