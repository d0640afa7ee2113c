// C++ CPU validation oracle (SURVEY.md T8 / L7, §7 PR6).
//
// Reference parity: plays the role of an independent ground-truth renderer
// for the JAX framework — the same job the visual output of the OpenCL
// reference's window served (SURVEY.md §4: the reference had no tests).
// This is a scalar, double-precision, textbook Moller-Trumbore path tracer
// with a median-split BVH, deliberately sharing no code or formulation with
// the JAX path (precompiled affine maps, cluster culling): agreement between
// the two is meaningful evidence of correctness.
//
// Shading model mirrors tracer/render/whitted.py and tracer/refcpu/oracle.py
// exactly: Lambert direct lighting with point lights, shadow rays with
// t_max = dist - 2*RAY_EPS from an origin offset RAY_EPS along the shading
// normal, ambient + emission, Whitted mirror bounces, miss -> sky.
//
// Built as a shared library by tracer/refcpu/cpp.py (g++ -O3 -shared) and
// called through ctypes; the numpy oracle remains the always-available
// fallback and definition of record.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double T_FAR = 1e30;
constexpr double T_MIN = 1e-4;
constexpr double RAY_EPS = 1e-4;

struct V3 {
  double x = 0, y = 0, z = 0;
};

static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator*(double s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
static inline V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
static inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline V3 normalize(V3 a) {
  double n = std::sqrt(dot(a, a));
  return (1.0 / std::max(n, 1e-20)) * a;
}
static inline V3 vmin(V3 a, V3 b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(V3 a, V3 b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Hit {
  double t = T_FAR;
  int tri = -1;
  double u = 0, v = 0;
};

// Textbook Moller-Trumbore, double-sided, same eps thresholds as the
// numpy oracle (_mt_one_ray in tracer/refcpu/oracle.py).
static inline bool mt_one(V3 o, V3 d, V3 v0, V3 v1, V3 v2, double t_min,
                          double t_max, double* t, double* u, double* v) {
  V3 e1 = v1 - v0;
  V3 e2 = v2 - v0;
  V3 pvec = cross(d, e2);
  double det = dot(e1, pvec);
  if (std::fabs(det) <= 1e-12) return false;
  double inv = 1.0 / det;
  V3 tvec = o - v0;
  double uu = dot(tvec, pvec) * inv;
  if (uu < 0.0) return false;
  V3 qvec = cross(tvec, e1);
  double vv = dot(d, qvec) * inv;
  if (vv < 0.0 || uu + vv > 1.0) return false;
  double tt = dot(e2, qvec) * inv;
  if (tt <= t_min || tt >= t_max) return false;
  *t = tt;
  *u = uu;
  *v = vv;
  return true;
}

struct Node {
  V3 lo, hi;
  int left = -1;    // internal: child index; leaf: first tri slot
  int count = 0;    // 0 = internal; >0 = leaf triangle count
  int right = -1;
};

class BVH {
 public:
  void build(const float* verts, const int32_t* tris, int nt) {
    verts_ = verts;
    tris_ = tris;
    order_.resize(nt);
    for (int i = 0; i < nt; ++i) order_[i] = i;
    centroid_.resize(nt);
    for (int i = 0; i < nt; ++i) {
      V3 a = vert(tris[3 * i]), b = vert(tris[3 * i + 1]), c = vert(tris[3 * i + 2]);
      centroid_[i] = (1.0 / 3.0) * (a + b + c);
    }
    nodes_.reserve(2 * nt);
    build_range(0, nt);
  }

  Hit closest(V3 o, V3 d, double t_min) const {
    Hit best;
    if (nodes_.empty()) return best;
    int stack[128];
    int sp = 0;
    stack[sp++] = 0;
    V3 inv = safe_inv(d);
    while (sp) {
      const Node& n = nodes_[stack[--sp]];
      if (!box_hit(n, o, inv, best.t)) continue;
      if (n.count) {
        for (int s = n.left; s < n.left + n.count; ++s) {
          int tri = order_[s];
          double t, u, v;
          if (mt_one(o, d, vert(tris_[3 * tri]), vert(tris_[3 * tri + 1]),
                     vert(tris_[3 * tri + 2]), t_min, best.t, &t, &u, &v)) {
            best = {t, tri, u, v};
          }
        }
      } else {
        stack[sp++] = n.left;
        stack[sp++] = n.right;
      }
    }
    return best;
  }

  bool occluded(V3 o, V3 d, double t_min, double t_max) const {
    if (nodes_.empty()) return false;
    int stack[128];
    int sp = 0;
    stack[sp++] = 0;
    V3 inv = safe_inv(d);
    while (sp) {
      const Node& n = nodes_[stack[--sp]];
      if (!box_hit(n, o, inv, t_max)) continue;
      if (n.count) {
        for (int s = n.left; s < n.left + n.count; ++s) {
          int tri = order_[s];
          double t, u, v;
          if (mt_one(o, d, vert(tris_[3 * tri]), vert(tris_[3 * tri + 1]),
                     vert(tris_[3 * tri + 2]), t_min, t_max, &t, &u, &v)) {
            return true;
          }
        }
      } else {
        stack[sp++] = n.left;
        stack[sp++] = n.right;
      }
    }
    return false;
  }

 private:
  V3 vert(int32_t i) const {
    return {verts_[3 * i], verts_[3 * i + 1], verts_[3 * i + 2]};
  }

  static V3 safe_inv(V3 d) {
    auto f = [](double x) { return x == 0.0 ? T_FAR : 1.0 / x; };
    return {f(d.x), f(d.y), f(d.z)};
  }

  static bool box_hit(const Node& n, V3 o, V3 inv, double t_best) {
    double t1 = (n.lo.x - o.x) * inv.x, t2 = (n.hi.x - o.x) * inv.x;
    double tn = std::min(t1, t2), tf = std::max(t1, t2);
    t1 = (n.lo.y - o.y) * inv.y, t2 = (n.hi.y - o.y) * inv.y;
    tn = std::max(tn, std::min(t1, t2)), tf = std::min(tf, std::max(t1, t2));
    t1 = (n.lo.z - o.z) * inv.z, t2 = (n.hi.z - o.z) * inv.z;
    tn = std::max(tn, std::min(t1, t2)), tf = std::min(tf, std::max(t1, t2));
    return tn <= tf && tf > 0.0 && tn < t_best;
  }

  int build_range(int begin, int end) {
    int idx = (int)nodes_.size();
    nodes_.emplace_back();
    V3 lo = {T_FAR, T_FAR, T_FAR}, hi = {-T_FAR, -T_FAR, -T_FAR};
    for (int s = begin; s < end; ++s) {
      int tri = order_[s];
      for (int k = 0; k < 3; ++k) {
        V3 p = vert(tris_[3 * tri + k]);
        lo = vmin(lo, p);
        hi = vmax(hi, p);
      }
    }
    nodes_[idx].lo = lo;
    nodes_[idx].hi = hi;
    int n = end - begin;
    if (n <= 4) {
      nodes_[idx].left = begin;
      nodes_[idx].count = n;
      return idx;
    }
    V3 ext = hi - lo;
    int axis = ext.x > ext.y ? (ext.x > ext.z ? 0 : 2) : (ext.y > ext.z ? 1 : 2);
    int mid = begin + n / 2;
    std::nth_element(order_.begin() + begin, order_.begin() + mid,
                     order_.begin() + end, [&](int a, int b) {
                       double ca = axis == 0 ? centroid_[a].x
                                 : axis == 1 ? centroid_[a].y : centroid_[a].z;
                       double cb = axis == 0 ? centroid_[b].x
                                 : axis == 1 ? centroid_[b].y : centroid_[b].z;
                       return ca < cb;
                     });
    int l = build_range(begin, mid);
    int r = build_range(mid, end);
    nodes_[idx].left = l;
    nodes_[idx].right = r;
    nodes_[idx].count = 0;
    return idx;
  }

  const float* verts_ = nullptr;
  const int32_t* tris_ = nullptr;
  std::vector<int> order_;
  std::vector<V3> centroid_;
  std::vector<Node> nodes_;
};

static inline V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

}  // namespace

extern "C" int oracle_render(
    const float* verts, int n_verts, const int32_t* tris, int n_tris,
    const int32_t* mat_id, const float* albedo, const float* emission,
    const float* mirror, const float* specular, const float* shininess,
    const float* normals, const float* light_pos,
    const float* light_int, int n_lights, const float* cam /* pos3 lookat3
    up3 fov_y_rad */, int height, int width, int max_bounces, int smooth,
    const float* sky_color, float ambient, float* out) {
  (void)n_verts;
  BVH bvh;
  bvh.build(verts, tris, n_tris);

  V3 pos = load3(cam);
  V3 fwd = normalize(load3(cam + 3) - pos);
  V3 right = normalize(cross(fwd, load3(cam + 6)));
  V3 up = cross(right, fwd);
  double tan_half = std::tan((double)cam[9] * 0.5);
  double aspect = (double)width / (double)height;
  V3 sky = load3(sky_color);

  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) {
      double ndc_x = ((x + 0.5) / width * 2.0 - 1.0) * aspect * tan_half;
      double ndc_y = (1.0 - (y + 0.5) / height * 2.0) * tan_half;
      V3 o = pos;
      V3 d = normalize(ndc_x * right + ndc_y * up + fwd);
      V3 throughput = {1, 1, 1};
      V3 color = {0, 0, 0};
      for (int bounce = 0; bounce < max_bounces; ++bounce) {
        Hit h = bvh.closest(o, d, T_MIN);
        if (h.tri < 0) {
          color = color + throughput * sky;
          break;
        }
        V3 p = o + h.t * d;
        const int32_t* idx = tris + 3 * h.tri;
        V3 n;
        if (smooth) {
          n = normalize((1.0 - h.u - h.v) * load3(normals + 3 * idx[0])
                        + h.u * load3(normals + 3 * idx[1])
                        + h.v * load3(normals + 3 * idx[2]));
        } else {
          V3 a = load3(verts + 3 * idx[0]);
          n = normalize(cross(load3(verts + 3 * idx[1]) - a,
                              load3(verts + 3 * idx[2]) - a));
        }
        if (dot(n, d) > 0.0) n = -1.0 * n;
        int m = mat_id[h.tri];
        V3 alb = load3(albedo + 3 * m);
        V3 direct = {0, 0, 0};
        for (int li = 0; li < n_lights; ++li) {
          V3 to_l = load3(light_pos + 3 * li) - p;
          double dist = std::sqrt(dot(to_l, to_l));
          V3 wi = (1.0 / dist) * to_l;
          double cos = std::max(dot(n, wi), 0.0);
          V3 so = p + RAY_EPS * n;
          double vis =
              bvh.occluded(so, wi, RAY_EPS, dist - 2 * RAY_EPS) ? 0.0 : 1.0;
          // Lambert + Phong lobe (mirrors render/whitted.phong_specular).
          V3 r = d - 2.0 * dot(d, n) * n;
          double cos_r = std::max(dot(r, wi), 0.0);
          double ks = specular[m];
          double ph = (ks > 0.0 && cos_r > 0.0)
                          ? ks * std::pow(cos_r, (double)shininess[m])
                          : 0.0;
          double falloff = vis / std::max(dist * dist, 1e-20);
          V3 brdf = (cos / M_PI) * alb + V3{ph, ph, ph};
          direct = direct + falloff * (brdf * load3(light_int + 3 * li));
        }
        V3 local = load3(emission + 3 * m) + (double)ambient * alb + direct;
        double mir = mirror[m];
        color = color + (1.0 - mir) * (throughput * local);
        if (bounce + 1 >= max_bounces || mir <= 0.0) break;
        d = normalize(d - 2.0 * dot(d, n) * n);
        o = p + RAY_EPS * n;
        throughput = mir * throughput;
      }
      float* px = out + 3 * (y * width + x);
      px[0] = (float)color.x;
      px[1] = (float)color.y;
      px[2] = (float)color.z;
    }
  }
  return 0;
}
