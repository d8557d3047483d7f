// The vacuum Z4 right-hand side (38 variables, zero shift) at one point, and
// the system's wave speed, as device code templated on the value type.
//
// It follows exahype_tpu_torch/models/z4.py::_z4_core_soa (the port's copy
// of exahype_tpu/models/z4.py::_z4_core_soa) stage by stage: the cofactor
// inverse, dgi, Glow, Gam, Gtr, dGlow, Ricci, the Hessian of the lapse,
// covZ, the traces, the r_* parts, then the symmetrised pack.  Every
// contraction is evaluated in _oein's order: output indices in order,
// contracted indices in sorted letter order (the first letter outermost),
// the operands multiplied left to right and the sum started from the first
// term.  Every other expression keeps the Python expression's association.
// So the kernel and the plain version differ by fused multiply-adds only
// (nvcc contracts a*b + c; the PyTorch version rounds each operation).
//
// The state is read through q(slot), the derivatives ∂_k Q through
// dq(k, slot), and the result is written through out(slot, value); the
// caller's accessors decide the layout.  The derivative entries are read
// where the algebra uses them, not all up front, to keep fewer of the 152
// inputs live at once.
//
// rhs may take an extension besides (its last argument): the parts pass
// through the extension's hooks on their way to out, before the
// symmetrisation, and its finish runs last; the shifted system's
// (csrc/z4_shift.cuh) adds its Lie-derivative terms and writes its gauge
// sector.  Without one (NoShift, the 38-variable system) the pack is the
// one this file had before extensions (an if constexpr branch), so that
// rhs compiles to the same machine code and its kernels give the same bits
// (with identity hooks the face flux kernel's NCP halves moved by an ulp).
#pragma once

#include <type_traits>

#include "device_math.cuh"

namespace z4 {

constexpr int kVars = 38;
// Variable slots (models/z4.py).
constexpr int kAl = 0, kG = 1, kK = 7, kTh = 13, kZ = 14, kA = 17, kD = 20;

// Slot of the symmetric pair (i, j) in the packed order SYM6 = (00, 01, 02,
// 11, 12, 22).
__host__ __device__ constexpr int sym(int i, int j) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  return lo == 0 ? hi : (lo == 1 ? hi + 2 : 5);
}

// The slicing, f, m, κ₁ and κ₂ of the system (models/z4.py::SLICINGS:
// 0 harmonic, 1 1+log).
struct Params {
  int slicing;
  double f, m, kappa1, kappa2;
};

// The extension of the zero-shift system: none.  An extension's hooks
// (csrc/z4_shift.cuh::Lie) each take a part (the r_* value of one
// component, before the symmetrisation) with what they need of the
// algebra's own values, and return the part.
struct NoShift {};

// ∂_t Q at one point (the parts through the extension *ext, if any).
template <typename T, typename LoadQ, typename LoadDQ, typename Store, typename Ext = NoShift>
__device__ __forceinline__ void rhs(const LoadQ& q, const LoadDQ& dq, const Params& p,
                                    const Store& out, Ext* ext = nullptr) {
  // The packed derivative entries, read where used.
  auto dK = [&](int k, int i, int j) { return dq(k, kK + sym(i, j)); };    // ∂_k K_ij
  auto dD = [&](int k, int l, int i, int j) {                            // ∂_k D_lij
    return dq(k, kD + 6 * l + sym(i, j));
  };

  // ------------------------------------------------------------ unpack
  const T al = q(kAl);
  const T th = q(kTh);
  T g[3][3], K[3][3], Z[3], A[3], D[3][3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Z[i] = q(kZ + i);
    A[i] = q(kA + i);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g[i][j] = q(kG + sym(i, j));
      K[i][j] = q(kK + sym(i, j));
#pragma unroll
      for (int k = 0; k < 3; ++k) D[i][j][k] = q(kD + 6 * i + sym(j, k));
    }
  }

  // ------------------------------------------------ cofactor inverse (gi)
  T gi[3][3];
  {
    const T a = g[0][0], b = g[0][1], c = g[0][2];
    const T d = g[1][0], e = g[1][1], f = g[1][2];
    const T g_ = g[2][0], h = g[2][1], i = g[2][2];
    const T ca = e * i - f * h;
    const T cb = f * g_ - d * i;
    const T cc = d * h - e * g_;
    const T det = a * ca + b * cb + c * cc;
    const T inv_det = T(1) / det;
    gi[0][0] = ca * inv_det;
    gi[0][1] = (c * h - b * i) * inv_det;
    gi[0][2] = (b * f - c * e) * inv_det;
    gi[1][0] = cb * inv_det;
    gi[1][1] = (a * i - c * g_) * inv_det;
    gi[1][2] = (c * d - a * f) * inv_det;
    gi[2][0] = cc * inv_det;
    gi[2][1] = (b * g_ - a * h) * inv_det;
    gi[2][2] = (a * e - b * d) * inv_det;
  }

  // dgi[k][l][m] = ∂_k γ^lm = −2 γ^la γ^mb D_kab
  T dgi[3][3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = 0; l < 3; ++l)
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        T acc;
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          const int a = c / 3, b = c % 3;
          const T t = gi[l][a] * gi[m][b] * D[k][a][b];
          acc = c ? acc + t : t;
        }
        dgi[k][l][m] = T(-2) * acc;
      }

  // Glow[l][i][j] = D_ijl + D_jil − D_lij;  Gam[k][i][j] = γ^kl Glow_lij
  T Glow[3][3][3], Gam[3][3][3];
#pragma unroll
  for (int l = 0; l < 3; ++l)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Glow[l][i][j] = D[i][j][l] + D[j][i][l] - D[l][i][j];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T acc;
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          const T t = gi[k][l] * Glow[l][i][j];
          acc = l ? acc + t : t;
        }
        Gam[k][i][j] = acc;
      }

  // Gtr[j] = γ^kl D_jkl
  T Gtr[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    T acc;
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const int k = c / 3, l = c % 3;
      const T t = gi[k][l] * D[j][k][l];
      acc = c ? acc + t : t;
    }
    Gtr[j] = acc;
  }

  // Ricci: R_ij = ∂_kΓ^k_ij − ∂_iΓ^k_kj + Γ^k_kl Γ^l_ij − Γ^k_li Γ^l_kj,
  // six contractions summed in the plain version's order, then symmetrised.
  // dGlow[k][l][i][j] = ∂_k D_ijl + ∂_k D_jil − ∂_k D_lij.
  T ric[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T t1, t2, t3, t4, t5, t6;
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        const int k = c / 3, l = c % 3;
        const T a1 = dgi[k][k][l] * Glow[l][i][j];
        const T dglow = dD(k, i, j, l) + dD(k, j, i, l) - dD(k, l, i, j);
        const T a2 = gi[k][l] * dglow;
        const T a3 = dgi[i][k][l] * D[j][k][l];
        const T a4 = gi[k][l] * dD(i, j, k, l);
        const T a6 = Gam[k][l][i] * Gam[l][k][j];
        t1 = c ? t1 + a1 : a1;
        t2 = c ? t2 + a2 : a2;
        t3 = c ? t3 + a3 : a3;
        t4 = c ? t4 + a4 : a4;
        t6 = c ? t6 + a6 : a6;
      }
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        const T a5 = Gtr[l] * Gam[l][i][j];
        t5 = l ? t5 + a5 : a5;
      }
      ric[i][j] = t1 + t2 - t3 - t4 + t5 - t6;
    }
  T rs[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) rs[i][j] = T(0.5) * (ric[i][j] + ric[j][i]);

  // ∇_i∇_j α / α (dA symmetrised) and covZ[i][j] = ∂_i Z_j − Γ^k_ij Z_k.
  T hess[3][3], covZ[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T ga, gz;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const T ta = Gam[k][i][j] * A[k];
        const T tz = Gam[k][i][j] * Z[k];
        ga = k ? ga + ta : ta;
        gz = k ? gz + tz : tz;
      }
      hess[i][j] = T(0.5) * (dq(i, kA + j) + dq(j, kA + i)) + A[i] * A[j] - ga;
      covZ[i][j] = dq(i, kZ + j) - gz;
    }

  // The traces and contractions of K.
  T trK, K2, Rs, divZ;
  T Kup[3][3], KK[3][3], Kmix[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T up, kk, mix;
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        const int a = c / 3, b = c % 3;
        const T t_up = gi[i][a] * gi[j][b] * K[a][b];
        const T t_kk = K[i][a] * gi[a][b] * K[b][j];
        up = c ? up + t_up : t_up;
        kk = c ? kk + t_kk : t_kk;
      }
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        const T t = gi[j][l] * K[i][l];
        mix = l ? mix + t : t;
      }
      Kup[i][j] = up;
      KK[i][j] = kk;
      Kmix[i][j] = mix;
    }
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const int i = c / 3, j = c % 3;
    const T a = gi[i][j] * K[i][j];
    const T b = K[i][j] * Kup[i][j];
    const T r = gi[i][j] * rs[i][j];
    const T z = gi[i][j] * covZ[i][j];
    trK = c ? trK + a : a;
    K2 = c ? K2 + b : b;
    Rs = c ? Rs + r : r;
    divZ = c ? divZ + z : z;
  }

  // ∇_j K_i^j (three contractions) and ∂_i tr K (two).
  T divKi[3], dtrK[3], Zup[3], KmixZ[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T s1, s2, s3, d1, d2;
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const int j = c / 3, l = c % 3;
      const T a1 = gi[j][l] * dK(j, i, l);
      const T b1 = dgi[i][j][l] * K[j][l];
      const T b2 = gi[j][l] * dK(i, j, l);
      s1 = c ? s1 + a1 : a1;
      d1 = c ? d1 + b1 : b1;
      d2 = c ? d2 + b2 : b2;
    }
#pragma unroll
    for (int c = 0; c < 27; ++c) {
      const int j = c / 9, l = (c / 3) % 3, m = c % 3;
      const T a2 = gi[j][l] * Gam[m][j][i] * K[m][l];
      const T a3 = gi[j][l] * Gam[m][j][l] * K[i][m];
      s2 = c ? s2 + a2 : a2;
      s3 = c ? s3 + a3 : a3;
    }
    divKi[i] = s1 - s2 - s3;
    dtrK[i] = d1 + d2;
    T zu, kz;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T a = gi[i][j] * Z[j];
      const T b = Kmix[i][j] * Z[j];
      zu = j ? zu + a : a;
      kz = j ? kz + b : b;
    }
    Zup[i] = zu;
    KmixZ[i] = kz;
  }

  // ------------------------------------------------------- the slicing
  const T gal = p.slicing == 0 ? T(p.f) : T(2) / al;
  const T ag = al * gal;
  const T dag = p.slicing == 0 ? T(p.f) : T(0);
  const T m = T(p.m);
  const T Kmth = trK - m * th;
  // The κ products are formed in double, as Python forms them before they
  // meet a tensor.
  const T c1 = T(p.kappa1 * (1.0 + p.kappa2));
  const T c2 = T(p.kappa1 * (2.0 + p.kappa2));
  const T k1 = T(p.kappa1);

  // ------------------------------------------------------- the r_* parts
  const T r_al = -ag * al * Kmth;
  T r_g[3][3], r_K[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r_g[i][j] = T(-2) * al * K[i][j];
      r_K[i][j] = -al * hess[i][j] +
                  al * (rs[i][j] + covZ[i][j] + covZ[j][i] - T(2) * KK[i][j] +
                        (trK - T(2) * th) * K[i][j]) -
                  c1 * al * th * g[i][j];
    }
  T ZA;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T t = Zup[i] * A[i];
    ZA = i ? ZA + t : t;
  }
  const T r_th = T(0.5) * al * (Rs + T(2) * divZ + (trK - T(2) * th) * trK - K2) - al * ZA -
                 c2 * al * th;

  // ------------------------------------------------------------ pack
  if constexpr (std::is_same_v<Ext, NoShift>) {
    out(kAl, r_al);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j) {
        out(kG + sym(i, j), T(0.5) * (r_g[i][j] + r_g[j][i]));
        out(kK + sym(i, j), T(0.5) * (r_K[i][j] + r_K[j][i]));
      }
    out(kTh, r_th);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T dth = dq(i, kTh);
      const T r_Z = al * (divKi[i] - dtrK[i] + dth - T(2) * KmixZ[i]) - al * th * A[i] -
                    k1 * al * Z[i];
      const T r_A = -dag * al * A[i] * Kmth - ag * (dtrK[i] - m * dth);
      out(kZ + i, r_Z);
      out(kA + i, r_A);
    }
    // r_D[k][i][j] = −α A_k K_ij − α ∂_k K_ij, symmetrised in (i, j).
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = i; j < 3; ++j) {
          const T rij = -al * A[k] * K[i][j] - al * dK(k, i, j);
          const T rji = -al * A[k] * K[j][i] - al * dK(k, j, i);
          out(kD + 6 * k + sym(i, j), T(0.5) * (rij + rji));
        }
  } else {
    // The same parts through the extension's hooks.
    ext->begin(q);
    out(kAl, ext->al(r_al, al, A));
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j) {
        out(kG + sym(i, j),
            T(0.5) * (ext->g(i, j, r_g[i][j], g, D) + ext->g(j, i, r_g[j][i], g, D)));
        out(kK + sym(i, j),
            T(0.5) * (ext->K(i, j, r_K[i][j], K, dq) + ext->K(j, i, r_K[j][i], K, dq)));
      }
    out(kTh, ext->th(r_th, dq));
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T dth = dq(i, kTh);
      const T r_Z = al * (divKi[i] - dtrK[i] + dth - T(2) * KmixZ[i]) - al * th * A[i] -
                    k1 * al * Z[i];
      const T r_A = -dag * al * A[i] * Kmth - ag * (dtrK[i] - m * dth);
      out(kZ + i, ext->Z(i, r_Z, Z, dq));
      out(kA + i, ext->A(i, r_A, A, dq));
    }
    // r_D[k][i][j] = −α A_k K_ij − α ∂_k K_ij, symmetrised in (i, j).
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = i; j < 3; ++j) {
          const T rij = -al * A[k] * K[i][j] - al * dK(k, i, j);
          const T rji = -al * A[k] * K[j][i] - al * dK(k, j, i);
          out(kD + 6 * k + sym(i, j),
              T(0.5) * (ext->D(k, i, j, rij, g, D, dq) + ext->D(k, j, i, rji, g, D, dq)));
        }
    ext->finish(g, D, dq, out);
  }
}

// The Rusanov bound along axis d (models/z4.py::z4_system's eig), the wider
// of the light and gauge cones: α √(max(g(α), 1) γ^dd), γ^dd the cofactor
// over the determinant as models/z4.py::inv3 forms them (the adjugate
// divided by the determinant), g(α) = f (harmonic) or 2/α (1+log).  q holds
// the 38 slots; d is the axis (0, 1, 2).
template <typename T>
__device__ __forceinline__ T wave_speed(const T* q, int d, const Params& p) {
  const T al = q[kAl];
  // The symmetric metric: a b c / b e f / c f i.
  const T a = q[kG + 0], b = q[kG + 1], c = q[kG + 2];
  const T e = q[kG + 3], f = q[kG + 4], i = q[kG + 5];
  const T ca = e * i - f * f;
  const T cb = f * c - b * i;
  const T cc = b * f - e * c;
  const T det = a * ca + b * cb + c * cc;
  const T cof = d == 0 ? ca : (d == 1 ? a * i - c * c : a * e - b * b);
  const T gdd = cof / det;
  T gal = p.slicing == 0 ? T(p.f) : T(2) / al;
  gal = gal < T(1) ? T(1) : gal;  // torch.clamp(min=1): NaN stays NaN
  return al * dsqrt(gal * gdd);
}

}  // namespace z4
