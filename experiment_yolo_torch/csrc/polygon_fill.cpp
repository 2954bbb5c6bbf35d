// Polygon fill of integer vertices into an int32 image, bit-equal to OpenCV
// 5.0's cv::fillPoly (LINE_8, shift 0, no offset): each polygon's outline is
// drawn 8-connected (Bresenham, clipped to the image), then its edges are
// filled scanline by scanline in 16.16 fixed point (CollectPolyEdges and
// FillEdgeCollection of OpenCV's drawing.cpp). In 5.0 an edge starts at its
// vertex's own x (no half-pixel offset), an edge that leaves the image takes
// the x of its clipped outline (and its rows too, unless the clipped outline
// is one row), and a span covers the pixel centres from ceil(left) to
// floor(right). Host code, built with g++; no library.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <vector>

namespace {

constexpr int XY_SHIFT = 16;
constexpr int64_t XY_ONE = int64_t(1) << XY_SHIFT;

struct P { int64_t x, y; };

struct PolyEdge {
  int y0 = 0, y1 = 0;
  int64_t x = 0, dx = 0;
  PolyEdge* next = nullptr;
};

// cv::clipLine on a w x h image; returns whether the line is (now) inside
bool clip_line(int64_t w, int64_t h, P& p1, P& p2) {
  int64_t right = w - 1, bottom = h - 1;
  if (w <= 0 || h <= 0) return false;
  int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// cv::LineIterator (8-connected, left to right) drawing ``color``; the end
// points go through int, as cv::Line takes cv::Point
void line8(int32_t* img, int w, int h, P a, P b, int32_t color) {
  P p1{(int)a.x, (int)a.y}, p2{(int)b.x, (int)b.y};
  if ((unsigned)p1.x >= (unsigned)w || (unsigned)p2.x >= (unsigned)w || (unsigned)p1.y >= (unsigned)h ||
      (unsigned)p2.y >= (unsigned)h) {
    bool inside = clip_line(w, h, p1, p2);
    p1 = {(int)p1.x, (int)p1.y};
    p2 = {(int)p2.x, (int)p2.y};
    if (!inside) return;
  }
  int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
  int64_t sx = 1, sy = 1;
  if (dx < 0) {  // left to right
    dx = -dx;
    dy = -dy;
    std::swap(p1, p2);
  }
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  bool vert = dy > dx;
  if (vert) std::swap(dx, dy);
  int64_t err = dx - (dy + dy), plus = dx + dx, minus = -(dy + dy), count = dx + 1;
  // the major axis moves every step, the minor one when err < 0 (before the update)
  int64_t mx = vert ? 0 : sx, my = vert ? sy : 0, px = vert ? sx : 0, py = vert ? 0 : sy;
  int64_t x = p1.x, y = p1.y;
  for (int64_t i = 0; i < count; ++i) {
    img[y * w + x] = color;
    bool m = err < 0;
    err += minus + (m ? plus : 0);
    x += mx + (m ? px : 0);
    y += my + (m ? py : 0);
  }
}

void collect_edges(int32_t* img, int w, int h, const int32_t* v, int count, std::vector<PolyEdge>& edges,
                   int32_t color) {
  P pt0{int64_t(v[2 * (count - 1)]) << XY_SHIFT, v[2 * (count - 1) + 1]}, pt1;
  for (int i = 0; i < count; i++, pt0 = pt1) {
    pt1 = {int64_t(v[2 * i]) << XY_SHIFT, v[2 * i + 1]};
    P pt0c = pt0, pt1c = pt1;
    P t0{(pt0.x + (XY_ONE >> 1)) >> XY_SHIFT, pt0.y}, t1{(pt1.x + (XY_ONE >> 1)) >> XY_SHIFT, pt1.y};
    line8(img, w, h, t0, t1, color);
    // an edge that leaves the image is rebuilt from its clipped outline
    if ((uint64_t)t0.x >= (uint64_t)w || (uint64_t)t1.x >= (uint64_t)w || (uint64_t)t0.y >= (uint64_t)h ||
        (uint64_t)t1.y >= (uint64_t)h) {
      clip_line(w, h, t0, t1);
      if (t0.y != t1.y) {
        pt0c.y = t0.y;
        pt1c.y = t1.y;
      }
      pt0c.x = t0.x << XY_SHIFT;
      pt1c.x = t1.x << XY_SHIFT;
    }
    if (pt0.y == pt1.y) continue;
    PolyEdge e;
    e.dx = (pt1c.x - pt0c.x) / (pt1c.y - pt0c.y);
    if (pt0.y < pt1.y) {
      e.y0 = (int)pt0.y;
      e.y1 = (int)pt1.y;
      e.x = pt0c.x + (e.y0 - pt0c.y) * e.dx;
    } else {
      e.y0 = (int)pt1.y;
      e.y1 = (int)pt0.y;
      e.x = pt1c.x + (e.y0 - pt1c.y) * e.dx;
    }
    edges.push_back(e);
  }
}

void fill_edges(int32_t* img, int w, int h, std::vector<PolyEdge>& edges, int32_t color) {
  int total = (int)edges.size();
  if (total < 2) return;
  int y_max = INT_MIN, y_min = INT_MAX;
  int64_t x_max = (int64_t)0xFFFFFFFFFFFFFFFF, x_min = 0x7FFFFFFFFFFFFFFF;
  for (const PolyEdge& e1 : edges) {
    int64_t x1 = e1.x + (e1.y1 - e1.y0) * e1.dx;
    y_min = std::min(y_min, e1.y0);
    y_max = std::max(y_max, e1.y1);
    x_min = std::min(x_min, std::min(e1.x, x1));
    x_max = std::max(x_max, std::max(e1.x, x1));
  }
  if (y_max < 0 || y_min >= h || x_max < 0 || x_min >= ((int64_t)w << XY_SHIFT)) return;
  std::sort(edges.begin(), edges.end(), [](const PolyEdge& a, const PolyEdge& b) {
    return a.y0 - b.y0 ? a.y0 < b.y0 : a.x - b.x ? a.x < b.x : a.dx < b.dx;
  });
  PolyEdge tmp;
  tmp.y0 = INT_MAX;
  edges.push_back(tmp);
  int i = 0;
  tmp.next = nullptr;
  PolyEdge* e = &edges[i];
  y_max = std::min(y_max, h);
  for (int y = e->y0; y < y_max; y++) {
    PolyEdge *last, *prelast, *keep_prelast;
    int draw = 0;
    bool clipline = y < 0;
    prelast = &tmp;
    last = tmp.next;
    while (last || e->y0 == y) {
      if (last && last->y1 == y) {  // the edge ends at this row
        prelast->next = last->next;
        last = last->next;
        continue;
      }
      keep_prelast = prelast;
      if (last && (e->y0 > y || last->x < e->x)) {
        prelast = last;
        last = last->next;
      } else if (i < total) {  // the next edge starts at this row
        prelast->next = e;
        e->next = last;
        prelast = e;
        e = &edges[++i];
      } else {
        break;
      }
      if (draw) {
        if (!clipline) {
          int64_t left = std::min(keep_prelast->x, prelast->x), right = std::max(keep_prelast->x, prelast->x);
          int x1 = (int)((left + XY_ONE - 1) >> XY_SHIFT), x2 = (int)(right >> XY_SHIFT);
          x1 = std::max(x1, 0);
          x2 = std::min(x2, w - 1);
          for (int x = x1; x <= x2; x++) img[(int64_t)y * w + x] = color;
        }
        keep_prelast->x += keep_prelast->dx;
        prelast->x += prelast->dx;
      }
      draw ^= 1;
    }
    // bubble sort of the active list by x
    keep_prelast = nullptr;
    do {
      prelast = &tmp;
      last = tmp.next;
      PolyEdge* last_exchange = nullptr;
      while (last != keep_prelast && last->next != nullptr) {
        PolyEdge* te = last->next;
        if (last->x > te->x) {
          prelast->next = te;
          last->next = te->next;
          te->next = last;
          prelast = te;
          last_exchange = prelast;
        } else {
          prelast = last;
          last = te;
        }
      }
      if (last_exchange == nullptr) break;
      keep_prelast = last_exchange;
    } while (keep_prelast != tmp.next && keep_prelast != &tmp);
  }
}

}  // namespace

extern "C" {

// Fill ``npolys`` polygons one after the other (one cv::fillPoly call each)
// into the h x w int32 image ``img``: polygon k has npts[k] >= 1 vertices
// (x, y), read in turn from ``pts``, and colour colors[k].
int fill_polys(int32_t* img, int h, int w, const int32_t* pts, const int32_t* npts, int npolys,
               const int32_t* colors) {
  std::vector<PolyEdge> edges;
  for (int k = 0; k < npolys; k++) {
    if (npts[k] < 1) return 1;
    edges.clear();
    edges.reserve(npts[k] + 1);
    collect_edges(img, w, h, pts, npts[k], edges, colors[k]);
    fill_edges(img, w, h, edges, colors[k]);
    pts += 2 * npts[k];
  }
  return 0;
}
}
