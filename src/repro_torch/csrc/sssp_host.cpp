// Host Dijkstra: the plain form of core/sssp.py::dijkstra, bit for bit.
//
// The plain form is a call with no destination, bans, cap, heuristic or
// reuse: the reverse shortest-path tree of the lazy reference stream
// (core/refstream.py::SidetrackTree) and the extended skeleton's splice
// searches (core/kspdg.py::_extended_skeleton).  The Python loop pops
// heapq's smallest (f, u) tuple; any min-priority queue ordered by
// (distance, vertex id) pops the same sequence, since the sequence
// depends only on the keys pushed, so this binary heap gives the same
// dist and parent arrays.  Every comparison and sum is the loop's own,
// in float64 (built without -ffast-math; x86-64 keeps doubles in SSE
// registers, so no extended precision enters).
//
// Plain C interface, built by kernels/_build.py::host_library with the
// host C++ compiler and loaded through ctypes.  Only libc is used, so the
// library loads on any host of the same architecture.

#include <cmath>
#include <cstdint>
#include <cstdlib>

namespace {

struct Entry {
  double f;
  int64_t u;
};

// heapq's tuple order: (f, u) lexicographic.  No key is NaN: a NaN sum
// never passes the strict-improvement test, so it is never pushed.
inline bool before(const Entry& a, const Entry& b) {
  return a.f < b.f || (a.f == b.f && a.u < b.u);
}

struct Heap {
  Entry* a = nullptr;
  int64_t size = 0;
  int64_t cap = 0;

  ~Heap() { std::free(a); }

  bool push(Entry e) {
    if (size == cap) {
      int64_t grown = cap ? 2 * cap : 1024;
      Entry* b = static_cast<Entry*>(std::realloc(a, grown * sizeof(Entry)));
      if (b == nullptr) return false;
      a = b;
      cap = grown;
    }
    int64_t i = size++;
    while (i > 0) {
      int64_t up = (i - 1) / 2;
      if (!before(e, a[up])) break;
      a[i] = a[up];
      i = up;
    }
    a[i] = e;
    return true;
  }

  Entry pop() {
    Entry top = a[0];
    Entry last = a[--size];
    int64_t i = 0;
    for (;;) {
      int64_t c = 2 * i + 1;
      if (c >= size) break;
      if (c + 1 < size && before(a[c + 1], a[c])) ++c;
      if (!before(a[c], last)) break;
      a[i] = a[c];
      i = c;
    }
    if (size > 0) a[i] = last;
    return top;
  }
};

}  // namespace

extern "C" {

// dist[n] and parent[n] are written in full.  Returns 0, or 1 where the
// CSR arrays are malformed (an offset or a neighbour out of range) and 2
// where the heap could not grow; the caller then runs the Python loop.
int sssp_dijkstra(int64_t n, int64_t m, const int64_t* indptr,
                  const int64_t* nbr, const double* hw, int64_t src,
                  double* dist, int64_t* parent) {
  if (n <= 0 || src < 0 || src >= n) return 1;
  for (int64_t u = 0; u < n; ++u) {
    if (indptr[u] < 0 || indptr[u] > indptr[u + 1]) return 1;
  }
  if (indptr[n] > m) return 1;
  for (int64_t v = 0; v < n; ++v) {
    dist[v] = INFINITY;
    parent[v] = -1;
  }
  dist[src] = 0.0;
  Heap heap;
  if (!heap.push({0.0, src})) return 2;
  while (heap.size > 0) {
    Entry e = heap.pop();
    int64_t u = e.u;
    double du = dist[u];
    if (e.f > du + 1e-12) continue;  // stale entry
    for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
      int64_t v = nbr[p];
      if (v < 0 || v >= n) return 1;
      double nd = du + hw[p];
      if (nd < dist[v] - 1e-15) {
        dist[v] = nd;
        parent[v] = u;
        if (!heap.push({nd, v})) return 2;
      }
    }
  }
  return 0;
}

}  // extern "C"
