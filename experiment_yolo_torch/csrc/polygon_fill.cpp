// Polygon fill of integer vertices into an int32 image, bit-equal to OpenCV
// 5.0's cv::fillPoly (LINE_8, shift 0, no offset): each polygon's outline is
// drawn 8-connected (Bresenham, clipped to the image), then its edges are
// filled scanline by scanline in 16.16 fixed point (CollectPolyEdges and
// FillEdgeCollection of OpenCV's drawing.cpp). In 5.0 an edge starts at its
// vertex's own x (no half-pixel offset), an edge that leaves the image takes
// the x of its clipped outline (and its rows too, unless the clipped outline
// is one row), and a span covers the pixel centres from ceil(left) to
// floor(right).
//
// Also the minimum-area rectangle of float32 points, bit-equal to OpenCV 5.0's
// cv::minAreaRect: cv::convexHull (Sklansky's scan over the points sorted by
// x then y, counter-clockwise, the same cyclic shift of the output), then
// rotatingCalipers (float edge vectors and inverse lengths, the caliper to
// advance chosen by the sign of a float cross product, the last rectangle of
// least float area kept), and the angle taken in double from the first side,
// brought into [-90, 0) degrees with the sides swapped at each 90-degree step.
// Host code, built with g++ (no contraction into multiply-adds); no library.
#include <algorithm>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
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


// ---- cv::minAreaRect ------------------------------------------------------

struct Pt { float x, y; };

int sign_of(double v) { return (v > 0) - (v < 0); }

// Sklansky's scan of array[start..end] (convhull.cpp:Sklansky_<float, double>)
int sklansky(const Pt* const* array, int start, int end, int* stack, int nsign, int sign2) {
  const int incr = end > start ? 1 : -1;
  int pprev = start, pcur = pprev + incr, pnext = pcur + incr;
  int stacksize = 3;
  if (start == end || (array[start]->x == array[end]->x && array[start]->y == array[end]->y)) {
    stack[0] = start;
    return 1;
  }
  stack[0] = pprev;
  stack[1] = pcur;
  stack[2] = pnext;
  end += incr;
  while (pnext != end) {
    const float cury = array[pcur]->y, nexty = array[pnext]->y;
    const float by = nexty - cury;
    if (sign_of(by) != nsign) {
      const float ax = array[pcur]->x - array[pprev]->x;
      const float bx = array[pnext]->x - array[pcur]->x;
      const float ay = cury - array[pprev]->y;
      const double convexity = (double)ay * bx - (double)ax * by;  // > 0: a convex angle
      if (sign_of(convexity) == sign2 && (ax != 0 || ay != 0)) {
        pprev = pcur;
        pcur = pnext;
        pnext += incr;
        stack[stacksize++] = pnext;
      } else if (pprev == start) {
        pcur = pnext;
        stack[1] = pcur;
        pnext += incr;
        stack[2] = pnext;
      } else {
        stack[stacksize - 2] = pnext;
        pcur = pprev;
        pprev = stack[stacksize - 4];
        stacksize--;
      }
    } else {
      pnext += incr;
      stack[stacksize - 1] = pnext;
    }
  }
  return --stacksize;
}

// cv::convexHull(points, hull, clockwise=false, returnPoints=true) of n >= 1 points
int convex_hull(const Pt* data0, int total, Pt* out) {
  std::vector<const Pt*> pointer(total);
  std::vector<int> stackbuf(total + 2), hullbuf(total);
  int* stack = stackbuf.data();
  for (int i = 0; i < total; i++) pointer[i] = &data0[i];
  std::sort(pointer.begin(), pointer.end(), [](const Pt* p1, const Pt* p2) {
    if (p1->x != p2->x) return p1->x < p2->x;
    if (p1->y != p2->y) return p1->y < p2->y;
    return p1 < p2;
  });
  const Pt* const* ptr = pointer.data();
  int miny_ind = 0, maxy_ind = 0, nout = 0;
  for (int i = 1; i < total; i++) {
    const float y = ptr[i]->y;
    if (ptr[miny_ind]->y > y) miny_ind = i;
    if (ptr[maxy_ind]->y < y) maxy_ind = i;
  }
  if (ptr[0]->x == ptr[total - 1]->x && ptr[0]->y == ptr[total - 1]->y) {
    hullbuf[nout++] = 0;
  } else {
    // upper half; counter-clockwise output takes the right part first
    int* tr_stack = stack;
    int tr_count = sklansky(ptr, 0, maxy_ind, tr_stack, -1, 1);
    int* tl_stack = stack + tr_count;
    int tl_count = sklansky(ptr, total - 1, maxy_ind, tl_stack, -1, -1);
    for (int i = 0; i < tl_count - 1; i++) hullbuf[nout++] = int(ptr[tl_stack[i]] - data0);
    for (int i = tr_count - 1; i > 0; i--) hullbuf[nout++] = int(ptr[tr_stack[i]] - data0);
    const int stop_idx = tr_count > 2 ? tr_stack[1] : tl_count > 2 ? tl_stack[tl_count - 2] : -1;

    // lower half
    int* bl_stack = stack;
    int bl_count = sklansky(ptr, 0, miny_ind, bl_stack, 1, -1);
    int* br_stack = stack + bl_count;
    int br_count = sklansky(ptr, total - 1, miny_ind, br_stack, 1, 1);
    if (stop_idx >= 0) {
      const int check_idx = bl_count > 2 ? bl_stack[1] : bl_count + br_count > 2 ? br_stack[2 - bl_count] : -1;
      if (check_idx == stop_idx || (check_idx >= 0 && ptr[check_idx]->x == ptr[stop_idx]->x &&
                                    ptr[check_idx]->y == ptr[stop_idx]->y)) {
        // all the points on one line: the lower part mirrors the upper
        bl_count = std::min(bl_count, 2);
        br_count = std::min(br_count, 2);
      }
    }
    for (int i = 0; i < bl_count - 1; i++) hullbuf[nout++] = int(ptr[bl_stack[i]] - data0);
    for (int i = br_count - 1; i > 0; i--) hullbuf[nout++] = int(ptr[br_stack[i]] - data0);

    // a cyclic shift that makes the indices ascend or descend, where one does
    if (nout >= 3) {
      int min_idx = 0, max_idx = 0, lt = 0;
      for (int i = 1; i < nout; i++) {
        const int idx = hullbuf[i];
        lt += hullbuf[i - 1] < idx;
        if (lt > 1 && lt <= i - 2) break;
        if (idx < hullbuf[min_idx]) min_idx = i;
        if (idx > hullbuf[max_idx]) max_idx = i;
      }
      const int mmdist = std::abs(max_idx - min_idx);
      if ((mmdist == 1 || mmdist == nout - 1) && (lt <= 1 || lt >= nout - 2)) {
        const int ascending = (max_idx + 1) % nout == min_idx;
        const int i0 = ascending ? min_idx : max_idx;
        if (i0 > 0) {
          int i, j = i0;
          for (i = 0; i < nout; i++) {
            const int curr_idx = stack[i] = hullbuf[j];
            const int next_j = j + 1 < nout ? j + 1 : 0;
            if (i < nout - 1 && (ascending != (curr_idx < hullbuf[next_j]))) break;
            j = next_j;
          }
          if (i == nout) std::memcpy(hullbuf.data(), stack, nout * sizeof(int));
        }
      }
    }
  }
  for (int i = 0; i < nout; i++) out[i] = data0[hullbuf[i]];
  return nout;
}

// vec1 lies clockwise of vec2 (rotcalipers.cpp:firstVecIsRight)
bool first_vec_is_right(const Pt& v1, const Pt& v2) {
  const Pt t = {v1.y, -v1.x};
  return t.x * v2.x + t.y * v2.y < 0;
}

// rotatingCalipers(points, n, CALIPERS_MINAREARECT, out) of n > 2 hull points:
// out = corner, first side, second side
void rotating_calipers(const Pt* points, int n, Pt* out) {
  float minarea = FLT_MAX;
  std::vector<float> inv_vect_length(n);
  std::vector<Pt> vect(n);
  int left = 0, bottom = 0, right = 0, top = 0;
  float orientation = 0, base_a, base_b = 0;
  Pt pt0 = points[0];
  float left_x = pt0.x, right_x = pt0.x, top_y = pt0.y, bottom_y = pt0.y;
  for (int i = 0; i < n; i++) {
    if (pt0.x < left_x) left_x = pt0.x, left = i;
    if (pt0.x > right_x) right_x = pt0.x, right = i;
    if (pt0.y > top_y) top_y = pt0.y, top = i;
    if (pt0.y < bottom_y) bottom_y = pt0.y, bottom = i;
    const Pt pt = points[i + 1 < n ? i + 1 : 0];
    const double dx = pt.x - pt0.x, dy = pt.y - pt0.y;
    vect[i] = {(float)dx, (float)dy};
    inv_vect_length[i] = (float)(1. / std::sqrt(dx * dx + dy * dy));
    pt0 = pt;
  }
  {  // the hull's orientation
    double ax = vect[n - 1].x, ay = vect[n - 1].y;
    for (int i = 0; i < n; i++) {
      const double bx = vect[i].x, by = vect[i].y;
      const double convexity = ax * by - ay * bx;
      if (convexity != 0) {
        orientation = convexity > 0 ? 1.f : -1.f;
        break;
      }
      ax = bx;
      ay = by;
    }
  }
  base_a = orientation;
  int seq[4] = {bottom, right, top, left};
  int best_left = 0, best_bottom = 0;
  float best_a = 0, best_b = 0, best_width = 0, best_height = 0;
  for (int k = 0; k < n; k++) {
    // the caliper whose side turns least to meet its next edge
    const Pt rot_vect[4] = {vect[seq[0]], {vect[seq[1]].y, -vect[seq[1]].x}, {-vect[seq[2]].x, -vect[seq[2]].y},
                            {-vect[seq[3]].y, vect[seq[3]].x}};
    int main_element = 0;
    for (int i = 1; i < 4; i++)
      if (first_vec_is_right(rot_vect[i], rot_vect[main_element])) main_element = i;
    const int pindex = seq[main_element];
    const float lead_x = vect[pindex].x * inv_vect_length[pindex];
    const float lead_y = vect[pindex].y * inv_vect_length[pindex];
    switch (main_element) {
      case 0: base_a = lead_x; base_b = lead_y; break;
      case 1: base_a = lead_y; base_b = -lead_x; break;
      case 2: base_a = -lead_x; base_b = -lead_y; break;
      default: base_a = -lead_y; base_b = lead_x; break;
    }
    seq[main_element] = seq[main_element] + 1 == n ? 0 : seq[main_element] + 1;

    float dx = points[seq[1]].x - points[seq[3]].x;
    float dy = points[seq[1]].y - points[seq[3]].y;
    const float width = dx * base_a + dy * base_b;
    dx = points[seq[2]].x - points[seq[0]].x;
    dy = points[seq[2]].y - points[seq[0]].y;
    const float height = -dx * base_b + dy * base_a;
    const float area = width * height;
    if (area <= minarea) {
      minarea = area;
      best_left = seq[3];
      best_bottom = seq[0];
      best_a = base_a;
      best_b = base_b;
      best_width = width;
      best_height = height;
    }
  }
  const float A1 = best_a, B1 = best_b, A2 = -best_b, B2 = best_a;
  const float C1 = A1 * points[best_left].x + points[best_left].y * B1;
  const float C2 = A2 * points[best_bottom].x + points[best_bottom].y * B2;
  const float idet = 1.f / (A1 * B2 - A2 * B1);
  out[0] = {(C1 * B2 - C2 * B1) * idet, (A1 * C2 - A2 * C1) * idet};
  out[1] = {A1 * best_width, B1 * best_width};
  out[2] = {A2 * best_height, B2 * best_height};
}

// cv::minAreaRect of n >= 1 points -> (cx, cy, w, h, angle in degrees)
void min_area_rect_one(const Pt* pts, int n, float* box) {
  std::vector<Pt> hull(n);
  const int h = convex_hull(pts, n, hull.data());
  float cx = 0, cy = 0, w = 0, hh = 0;
  double angle = 0;
  if (h > 2) {
    Pt out[3];
    rotating_calipers(hull.data(), h, out);
    cx = out[0].x + (out[1].x + out[2].x) * 0.5f;
    cy = out[0].y + (out[1].y + out[2].y) * 0.5f;
    w = (float)std::sqrt((double)out[1].x * out[1].x + (double)out[1].y * out[1].y);
    hh = (float)std::sqrt((double)out[2].x * out[2].x + (double)out[2].y * out[2].y);
    angle = std::atan2((double)out[1].y, (double)out[1].x);
  } else if (h == 2) {
    cx = (hull[0].x + hull[1].x) * 0.5f;
    cy = (hull[0].y + hull[1].y) * 0.5f;
    const double dx = hull[1].x - hull[0].x, dy = hull[1].y - hull[0].y;
    w = (float)std::sqrt(dx * dx + dy * dy);
    angle = std::atan2(dy, dx);
  } else {
    cx = hull[0].x;
    cy = hull[0].y;
  }
  angle = angle * 180 / 3.1415926535897932384626433832795;
  while (angle >= 0) {
    angle -= 90;
    std::swap(w, hh);
  }
  while (angle < -90) {
    angle += 90;
    std::swap(w, hh);
  }
  box[0] = cx;
  box[1] = cy;
  box[2] = w;
  box[3] = hh;
  box[4] = (float)angle;
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

// cv::minAreaRect of each of ``count`` point sets of ``npts`` >= 1 (x, y)
// float32 points, read in turn from ``pts``: box k = (cx, cy, w, h, angle
// in degrees) at out[5k].
void min_area_rects(const float* pts, int count, int npts, float* out) {
  for (int k = 0; k < count; k++)
    min_area_rect_one(reinterpret_cast<const Pt*>(pts) + static_cast<long long>(k) * npts, npts, out + 5 * k);
}
}
