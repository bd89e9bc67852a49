// Rigid-body grasp-stability simulator.
//
// Native replacement for the reference's pybullet + V-HACD pipeline
// (mano_train/simulation/simulate.py:111-345): a static concave hand mesh
// (triangle soup) and one dynamic rigid object dropped under gravity; the
// metric is the displacement of the object's center of mass after a fixed
// number of steps.  The reference runs 35 steps at 1/240 s with gravity
// +9.8 on y, mass 1, and PER-BODY materials (simulate.py:117-145): hand
// friction 3 / restitution 0, object friction 3 / restitution 0.5.  Like
// pybullet's default combiners, contact friction and restitution are the
// PRODUCTS of the two bodies' values (so the reference protocol yields
// friction 9 and restitution 0 — inelastic contacts).
//
// Collision model, two symmetric contact families per substep:
//   1. object vertices vs static hand triangles (point-triangle closest
//      point on a uniform grid built once per call);
//   2. hand vertices vs object triangles, evaluated in the object's local
//      frame against a second static grid — this plays the role of
//      pybullet's V-HACD convex decomposition (solid-vs-solid contacts
//      instead of a one-sided point shell).
// Impulse-based resolution with Coulomb friction and Baumgarte positional
// correction.  This is not a pybullet clone — it is a compact,
// deterministic stepper producing the same *kind* of metric (how far the
// object falls / slides when released into the predicted grasp).
//
// Build: g++ -O3 -shared -fPIC physics.cpp -o libobman_physics.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  double x = 0, y = 0, z = 0;
};

inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(V3 a, double s) { return {a.x * s, a.y * s, a.z * s}; }
inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double norm(V3 a) { return std::sqrt(dot(a, a)); }
inline V3 normalized(V3 a) {
  double n = norm(a);
  return n > 1e-12 ? a * (1.0 / n) : V3{0, 0, 0};
}

// Closest point on triangle (Ericson, Real-Time Collision Detection §5.1.5)
V3 closest_point_triangle(V3 p, V3 a, V3 b, V3 c) {
  V3 ab = b - a, ac = c - a, ap = p - a;
  double d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) return a;
  V3 bp = p - b;
  double d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) return b;
  double vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    double v = d1 / (d1 - d3);
    return a + ab * v;
  }
  V3 cp = p - c;
  double d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) return c;
  double vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    double w = d2 / (d2 - d6);
    return a + ac * w;
  }
  double va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    return b + (c - b) * w;
  }
  double denom = 1.0 / (va + vb + vc);
  double v = vb * denom, w = vc * denom;
  return a + ab * v + ac * w;
}

struct Grid {
  double cell = 1.0;
  V3 origin;
  int nx = 0, ny = 0, nz = 0;
  std::vector<std::vector<int>> cells;

  int idx(int ix, int iy, int iz) const {
    return (ix * ny + iy) * nz + iz;
  }
};

Grid build_grid(const std::vector<V3>& tri_min, const std::vector<V3>& tri_max,
                double cell) {
  Grid g;
  g.cell = cell;
  V3 lo{1e30, 1e30, 1e30}, hi{-1e30, -1e30, -1e30};
  for (size_t t = 0; t < tri_min.size(); ++t) {
    lo.x = std::fmin(lo.x, tri_min[t].x); hi.x = std::fmax(hi.x, tri_max[t].x);
    lo.y = std::fmin(lo.y, tri_min[t].y); hi.y = std::fmax(hi.y, tri_max[t].y);
    lo.z = std::fmin(lo.z, tri_min[t].z); hi.z = std::fmax(hi.z, tri_max[t].z);
  }
  g.origin = lo;
  g.nx = std::max(1, (int)((hi.x - lo.x) / cell) + 1);
  g.ny = std::max(1, (int)((hi.y - lo.y) / cell) + 1);
  g.nz = std::max(1, (int)((hi.z - lo.z) / cell) + 1);
  // cap grid size
  const long max_cells = 2'000'000;
  while ((long)g.nx * g.ny * g.nz > max_cells) {
    g.cell *= 1.5;
    g.nx = std::max(1, (int)((hi.x - lo.x) / g.cell) + 1);
    g.ny = std::max(1, (int)((hi.y - lo.y) / g.cell) + 1);
    g.nz = std::max(1, (int)((hi.z - lo.z) / g.cell) + 1);
  }
  g.cells.assign((size_t)g.nx * g.ny * g.nz, {});
  for (size_t t = 0; t < tri_min.size(); ++t) {
    int x0 = (int)((tri_min[t].x - lo.x) / g.cell);
    int y0 = (int)((tri_min[t].y - lo.y) / g.cell);
    int z0 = (int)((tri_min[t].z - lo.z) / g.cell);
    int x1 = (int)((tri_max[t].x - lo.x) / g.cell);
    int y1 = (int)((tri_max[t].y - lo.y) / g.cell);
    int z1 = (int)((tri_max[t].z - lo.z) / g.cell);
    for (int ix = x0; ix <= x1; ++ix)
      for (int iy = y0; iy <= y1; ++iy)
        for (int iz = z0; iz <= z1; ++iz)
          g.cells[g.idx(ix, iy, iz)].push_back((int)t);
  }
  return g;
}

struct Quat {
  double w = 1, x = 0, y = 0, z = 0;
};

Quat quat_mul(Quat a, Quat b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

void quat_normalize(Quat& q) {
  double n = std::sqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  if (n > 1e-12) {
    q.w /= n; q.x /= n; q.y /= n; q.z /= n;
  } else {
    q = {1, 0, 0, 0};
  }
}

V3 rotate(Quat q, V3 v) {
  V3 u{q.x, q.y, q.z};
  V3 t = cross(u, v) * 2.0;
  return v + t * q.w + cross(u, t);
}

inline Quat conj(Quat q) { return {q.w, -q.x, -q.y, -q.z}; }

}  // namespace

extern "C" {

// Returns 0 on success. out_displacement: final center displacement (same
// units as inputs). obj_faces may be null (disables the hand-vertex vs
// object-triangle contact family). out_traj (n_steps * 3) optional.
// Contact friction/restitution are the products of the per-body values
// (pybullet's default material combiners).
int run_grasp_simulation(
    const double* hand_verts, int n_hand_verts,
    const int32_t* hand_faces, int n_hand_faces,
    const double* obj_verts, int n_obj_verts,
    const int32_t* obj_faces, int n_obj_faces,
    double dt, int n_steps, int substeps,
    double gravity_y,
    double hand_friction, double obj_friction,
    double hand_restitution, double obj_restitution,
    double contact_margin,
    double* out_displacement, double* out_traj) {
  if (n_hand_verts <= 0 || n_hand_faces <= 0 || n_obj_verts <= 0) return 1;
  const double friction = hand_friction * obj_friction;
  double restitution = hand_restitution * obj_restitution;
  if (restitution > 1.0) restitution = 1.0;

  // Hand triangles in world space (static).
  std::vector<V3> ta(n_hand_faces), tb(n_hand_faces), tc(n_hand_faces);
  std::vector<V3> tmin(n_hand_faces), tmax(n_hand_faces);
  auto hv = [&](int i) {
    return V3{hand_verts[3 * i], hand_verts[3 * i + 1], hand_verts[3 * i + 2]};
  };
  for (int f = 0; f < n_hand_faces; ++f) {
    ta[f] = hv(hand_faces[3 * f]);
    tb[f] = hv(hand_faces[3 * f + 1]);
    tc[f] = hv(hand_faces[3 * f + 2]);
    tmin[f] = {std::fmin(ta[f].x, std::fmin(tb[f].x, tc[f].x)) - contact_margin,
               std::fmin(ta[f].y, std::fmin(tb[f].y, tc[f].y)) - contact_margin,
               std::fmin(ta[f].z, std::fmin(tb[f].z, tc[f].z)) - contact_margin};
    tmax[f] = {std::fmax(ta[f].x, std::fmax(tb[f].x, tc[f].x)) + contact_margin,
               std::fmax(ta[f].y, std::fmax(tb[f].y, tc[f].y)) + contact_margin,
               std::fmax(ta[f].z, std::fmax(tb[f].z, tc[f].z)) + contact_margin};
  }
  Grid grid = build_grid(tmin, tmax, std::fmax(contact_margin * 4.0, 0.01));

  // Object body: center of mass = vertex mean; local vertex offsets.
  V3 com{0, 0, 0};
  for (int i = 0; i < n_obj_verts; ++i)
    com = com + V3{obj_verts[3 * i], obj_verts[3 * i + 1], obj_verts[3 * i + 2]};
  com = com * (1.0 / n_obj_verts);
  std::vector<V3> local(n_obj_verts);
  double r2_sum = 0;
  for (int i = 0; i < n_obj_verts; ++i) {
    local[i] = V3{obj_verts[3 * i], obj_verts[3 * i + 1], obj_verts[3 * i + 2]} - com;
    r2_sum += dot(local[i], local[i]);
  }

  // Object triangles in the object's LOCAL frame (for the hand-vertex vs
  // object-triangle contact family), plus their own static grid.
  const bool obj_tris = obj_faces != nullptr && n_obj_faces > 0;
  std::vector<V3> oa, ob, oc, on;  // on = outward local face normals
  Grid ogrid;
  if (obj_tris) {
    oa.resize(n_obj_faces); ob.resize(n_obj_faces); oc.resize(n_obj_faces);
    on.resize(n_obj_faces);
    std::vector<V3> omin(n_obj_faces), omax(n_obj_faces);
    for (int f = 0; f < n_obj_faces; ++f) {
      oa[f] = local[obj_faces[3 * f]];
      ob[f] = local[obj_faces[3 * f + 1]];
      oc[f] = local[obj_faces[3 * f + 2]];
      // Outward orientation: away from the center of mass (local origin);
      // exact for star-shaped objects, which deformed icospheres are.
      on[f] = normalized(cross(ob[f] - oa[f], oc[f] - oa[f]));
      V3 centroid = (oa[f] + ob[f] + oc[f]) * (1.0 / 3.0);
      if (dot(on[f], centroid) < 0) on[f] = on[f] * -1.0;
      omin[f] = {std::fmin(oa[f].x, std::fmin(ob[f].x, oc[f].x)) - contact_margin,
                 std::fmin(oa[f].y, std::fmin(ob[f].y, oc[f].y)) - contact_margin,
                 std::fmin(oa[f].z, std::fmin(ob[f].z, oc[f].z)) - contact_margin};
      omax[f] = {std::fmax(oa[f].x, std::fmax(ob[f].x, oc[f].x)) + contact_margin,
                 std::fmax(oa[f].y, std::fmax(ob[f].y, oc[f].y)) + contact_margin,
                 std::fmax(oa[f].z, std::fmax(ob[f].z, oc[f].z)) + contact_margin};
    }
    ogrid = build_grid(omin, omax, std::fmax(contact_margin * 4.0, 0.01));
  }
  const double mass = 1.0;
  // Solid-sphere inertia approximation from the RMS vertex radius.
  double r2 = r2_sum / n_obj_verts;
  double inertia = std::fmax(2.0 / 5.0 * mass * r2, 1e-9);
  double inv_mass = 1.0 / mass;
  double inv_inertia = 1.0 / inertia;

  V3 x = com;
  Quat q;
  V3 v{0, 0, 0}, w{0, 0, 0};
  const V3 g{0, gravity_y, 0};
  const double h = dt / substeps;
  const double beta = 0.2;  // Baumgarte positional correction factor

  // Apply one contact impulse at object offset r with normal n (pointing
  // from the hand into the object).  ``pen`` is the TRUE surface
  // penetration (0 while the contact only grazes the margin shell): the
  // Baumgarte bias must not fire inside the margin or resting bodies get
  // catapulted off the surface.
  auto resolve_contact = [&](V3 r, V3 n, double pen) {
    V3 vel = v + cross(w, r);
    double vn = dot(vel, n);
    // effective mass along the normal at this contact
    V3 rxn = cross(r, n);
    double k = inv_mass + inv_inertia * dot(rxn, rxn);
    double bias = beta * pen / h;
    double jn = -(1.0 + restitution) * vn / k;
    jn = std::fmax(jn, 0.0);
    double jb = std::fmax(bias / k, 0.0);
    V3 impulse = n * (jn + jb);
    // Coulomb friction on the tangential velocity
    V3 vt = vel - n * vn;
    double vt_norm = norm(vt);
    if (vt_norm > 1e-9) {
      V3 tdir = vt * (-1.0 / vt_norm);
      V3 rxt = cross(r, tdir);
      double kt = inv_mass + inv_inertia * dot(rxt, rxt);
      double jt = vt_norm / kt;
      jt = std::fmin(jt, friction * (jn + jb));
      impulse = impulse + tdir * jt;
    }
    v = v + impulse * inv_mass;
    w = w + cross(r, impulse) * inv_inertia;
  };

  for (int step = 0; step < n_steps; ++step) {
    for (int sub = 0; sub < substeps; ++sub) {
      v = v + g * h;
      // Contact family 1: object vertices vs hand triangles
      // (one Gauss-Seidel pass over contacts).
      for (int i = 0; i < n_obj_verts; ++i) {
        V3 r = rotate(q, local[i]);
        V3 p = x + r;
        int ix = (int)((p.x - grid.origin.x) / grid.cell);
        int iy = (int)((p.y - grid.origin.y) / grid.cell);
        int iz = (int)((p.z - grid.origin.z) / grid.cell);
        if (ix < 0 || iy < 0 || iz < 0 || ix >= grid.nx || iy >= grid.ny ||
            iz >= grid.nz)
          continue;
        const auto& cand = grid.cells[grid.idx(ix, iy, iz)];
        double best_d = contact_margin;
        V3 best_cpt{0, 0, 0}, best_nf{0, 0, 0};
        bool hit = false;
        for (int t : cand) {
          V3 cpt = closest_point_triangle(p, ta[t], tb[t], tc[t]);
          double d = norm(p - cpt);
          if (d < best_d) {
            best_d = d;
            best_cpt = cpt;
            best_nf = normalized(cross(tb[t] - ta[t], tc[t] - ta[t]));
            hit = true;
          }
        }
        if (!hit) continue;
        // Orient the hand-surface normal toward the OBJECT's center: the
        // body lies on the non-hand side of the skin, so this is the
        // separating direction even when the vertex starts slightly
        // penetrated (a vertex-side normal would flip there and the
        // Baumgarte bias would eject the object THROUGH the surface).
        V3 n = best_nf;
        if (dot(x - best_cpt, n) < 0) n = n * -1.0;
        double sd = dot(p - best_cpt, n);  // signed: + = object side
        if (sd >= contact_margin) continue;
        resolve_contact(rotate(q, local[i]), n, std::fmax(-sd, 0.0));
      }
      // Contact family 2: hand vertices vs object triangles, evaluated in
      // the object's local frame (solid-vs-solid; V-HACD's role).
      if (obj_tris) {
        Quat qc = conj(q);
        for (int i = 0; i < n_hand_verts; ++i) {
          V3 p{hand_verts[3 * i], hand_verts[3 * i + 1], hand_verts[3 * i + 2]};
          V3 pl = rotate(qc, p - x);
          int ix = (int)((pl.x - ogrid.origin.x) / ogrid.cell);
          int iy = (int)((pl.y - ogrid.origin.y) / ogrid.cell);
          int iz = (int)((pl.z - ogrid.origin.z) / ogrid.cell);
          if (ix < 0 || iy < 0 || iz < 0 || ix >= ogrid.nx || iy >= ogrid.ny ||
              iz >= ogrid.nz)
            continue;
          const auto& cand = ogrid.cells[ogrid.idx(ix, iy, iz)];
          double best_d = contact_margin;
          V3 best_cpt{0, 0, 0};
          int best_t = -1;
          for (int t : cand) {
            V3 cpt = closest_point_triangle(pl, oa[t], ob[t], oc[t]);
            double d = norm(pl - cpt);
            if (d < best_d) {
              best_d = d;
              best_cpt = cpt;
              best_t = t;
            }
          }
          if (best_t < 0) continue;
          // Push direction for the object = its INWARD surface normal at
          // the contact (a support pushes a resting body toward the body's
          // interior) — correct whether the hand vertex is just outside or
          // already penetrating, unlike normalized(cpt - p) which flips.
          V3 r = rotate(q, best_cpt);        // world offset of surface point
          V3 n = rotate(q, on[best_t]) * -1.0;
          // signed distance of the hand vertex along the outward normal:
          // negative = inside the object = true penetration.
          double sd = dot(pl - best_cpt, on[best_t]);
          resolve_contact(r, n, std::fmax(-sd, 0.0));
        }
      }
      x = x + v * h;
      // integrate orientation: dq = 0.5 * (0, w) * q * h
      Quat wq{0, w.x, w.y, w.z};
      Quat dq = quat_mul(wq, q);
      q.w += 0.5 * dq.w * h;
      q.x += 0.5 * dq.x * h;
      q.y += 0.5 * dq.y * h;
      q.z += 0.5 * dq.z * h;
      quat_normalize(q);
    }
    if (out_traj) {
      out_traj[3 * step] = x.x;
      out_traj[3 * step + 1] = x.y;
      out_traj[3 * step + 2] = x.z;
    }
  }
  V3 d = x - com;
  *out_displacement = norm(d);
  return 0;
}

}  // extern "C"
