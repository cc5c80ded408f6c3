// Double-precision Möller–Trumbore nearest-hit — the native core of the
// parity oracle (lightpycl_tpu/tracer/oracle.py).
//
// Reference parity: the same test the reference's OpenCL `intersect` kernel
// performs (SURVEY.md §3 'Intersect kernel'), here in plain C++ f64 so the
// golden tracer can cover config-4-scale scenes (1e10+ tests) that numpy
// cannot reach on one host core. Deliberately the classic MT formulation —
// independent from the device path's unit-triangle transforms — so
// agreement is evidence of correctness, not shared bugs.
//
// C ABI only; loaded via ctypes (no pybind11 in this environment).

#include <cmath>
#include <cstdint>

extern "C" {

// rays: o (n,3), d (n,3); triangles: v0/e1/e2 (m,3); out: t (n), idx (n).
// idx = -1 on miss, t = +inf. eps/eps_b/t_max as in TraceConfig.
void mt_nearest_hit(const double* o, const double* d, int64_t n,
                    const double* v0, const double* e1, const double* e2,
                    int64_t m, double eps, double eps_b, double t_max,
                    double* t_out, int64_t* idx_out) {
    for (int64_t r = 0; r < n; ++r) {
        const double ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
        const double dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
        double best_t = INFINITY;
        int64_t best_i = -1;
        for (int64_t k = 0; k < m; ++k) {
            const double e1x = e1[3 * k], e1y = e1[3 * k + 1], e1z = e1[3 * k + 2];
            const double e2x = e2[3 * k], e2y = e2[3 * k + 1], e2z = e2[3 * k + 2];
            // h = d x e2
            const double hx = dy * e2z - dz * e2y;
            const double hy = dz * e2x - dx * e2z;
            const double hz = dx * e2y - dy * e2x;
            const double a = e1x * hx + e1y * hy + e1z * hz;
            if (a > -1e-300 && a < 1e-300) continue;
            const double f = 1.0 / a;
            const double sx = ox - v0[3 * k];
            const double sy = oy - v0[3 * k + 1];
            const double sz = oz - v0[3 * k + 2];
            const double u = f * (sx * hx + sy * hy + sz * hz);
            if (u < -eps_b || u > 1.0 + eps_b) continue;
            // q = s x e1
            const double qx = sy * e1z - sz * e1y;
            const double qy = sz * e1x - sx * e1z;
            const double qz = sx * e1y - sy * e1x;
            const double v = f * (dx * qx + dy * qy + dz * qz);
            if (v < -eps_b || u + v > 1.0 + eps_b) continue;
            const double t = f * (e2x * qx + e2y * qy + e2z * qz);
            if (t > eps && t < t_max && t < best_t) {
                best_t = t;
                best_i = k;
            }
        }
        t_out[r] = best_t;
        idx_out[r] = best_i;
    }
}

}  // extern "C"
