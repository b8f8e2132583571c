// Fast PGM (P5) codec — the native IO path for large boards.
//
// The reference's IO is a Go goroutine streaming one byte at a time over a
// channel (reference: gol/io.go:42-126). This framework's default codec is
// vectorised Python (io/pgm.py); this C++ codec is the accelerated path for
// boards where even that matters (multi-GiB streamed shard IO, SURVEY.md §7
// step 6): raw pread/pwrite with no interpreter in the loop.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).
// Build: io/native.py builds it with g++ at first use into build/native/ at
// the root of the checkout (or run `make` here).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

// Parse the P5 header: magic, width, height, maxval, raster offset.
// Handles '#' comments and arbitrary whitespace. Returns 0 on success.
int parse_header(const unsigned char* buf, long len, long* width, long* height,
                 long* maxval, long* offset) {
  long pos = 0;
  long fields[3];
  int nfields = 0;
  if (len < 2 || buf[0] != 'P' || buf[1] != '5') return -1;
  pos = 2;
  while (nfields < 3) {
    if (pos >= len) return -1;
    unsigned char c = buf[pos];
    if (c == '#') {
      while (pos < len && buf[pos] != '\n') pos++;
    } else if (c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
               c == '\f') {
      pos++;
    } else if (c >= '0' && c <= '9') {
      long v = 0;
      while (pos < len && buf[pos] >= '0' && buf[pos] <= '9') {
        v = v * 10 + (buf[pos] - '0');
        pos++;
      }
      fields[nfields++] = v;
    } else {
      return -1;
    }
  }
  // exactly one whitespace byte before the raster
  if (pos >= len) return -1;
  unsigned char c = buf[pos];
  if (!(c == ' ' || c == '\t' || c == '\n' || c == '\r')) return -1;
  pos++;
  *width = fields[0];
  *height = fields[1];
  *maxval = fields[2];
  *offset = pos;
  return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success; fills width/height/maxval/offset.
int golio_read_header(const char* path, long* width, long* height,
                      long* maxval, long* offset) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  unsigned char buf[4096];
  ssize_t n = read(fd, buf, sizeof(buf));
  close(fd);
  if (n <= 0) return -1;
  return parse_header(buf, (long)n, width, height, maxval, offset);
}

// Read rows [start, stop) of the raster into out (caller-allocated,
// (stop-start)*width bytes). Returns 0 on success.
int golio_read_rows(const char* path, long offset, long width, long start,
                    long stop, unsigned char* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  long total = (stop - start) * width;
  off_t at = offset + (off_t)start * width;
  long done = 0;
  while (done < total) {
    ssize_t n = pread(fd, out + done, total - done, at + done);
    if (n <= 0) {
      close(fd);
      return n == 0 ? -1 : -errno;
    }
    done += n;
  }
  close(fd);
  return 0;
}

// Write a whole board as P5 (header + raster), fsync'd like the reference
// (gol/io.go:84-85). Returns 0 on success.
int golio_write(const char* path, long width, long height,
                const unsigned char* data) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  char header[64];
  int hlen = snprintf(header, sizeof(header), "P5\n%ld %ld\n255\n", width,
                      height);
  ssize_t hw = write(fd, header, hlen);
  if (hw != hlen) {
    // a short write may not set errno; never report success for it
    int e = hw < 0 ? errno : EIO;
    close(fd);
    return -e;
  }
  long total = width * height;
  long done = 0;
  while (done < total) {
    ssize_t n = write(fd, data + done, total - done);
    if (n <= 0) {
      int e = n < 0 ? errno : EIO;
      close(fd);
      return -e;
    }
    done += n;
  }
  if (fsync(fd) != 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  return close(fd) == 0 ? 0 : -errno;
}

// Append rows to an already-open file descriptor (streamed shard writes).
int golio_write_rows_fd(int fd, long width, long nrows,
                        const unsigned char* data) {
  long total = width * nrows;
  long done = 0;
  while (done < total) {
    ssize_t n = write(fd, data + done, total - done);
    if (n <= 0) return n < 0 ? -errno : -EIO;
    done += n;
  }
  return 0;
}

}  // extern "C"
