"""Material model.

Port counterpart of lightpycl_tpu/materials.py: a jax-free copy, unchanged
below this paragraph.

Reference parity: LightPyCL encodes per-element surface behavior as a small
integer for the kernel (SURVEY.md §3 "Materials", geo_optical_elements.py +
iterative_tracer.py flattening [recalled]). Four behaviors:

  * MIRROR      — specular reflection, power scaled by `reflectivity`
  * REFRACTIVE  — dielectric: Snell refraction + Fresnel unpolarized power
                  split (both children continue), total internal reflection
  * TERMINATOR  — absorbs the ray (power accounted as absorbed)
  * MEASURE     — records the ray (power into detector bins) and absorbs it
  * POLARIZER / WAVEPLATE — extensions: ideal linear polarizer (Malus) and
                  linear retarder along a per-element `axis`; both require
                  TraceConfig(polarization=True) since they act on Stokes
                  state
  * BEAMSPLITTER — extension beyond the reference: angle-independent
                  coating split — reflected child carries `reflectivity`
                  of the power, a straight-through transmitted child
                  carries the rest (no refraction, no medium change) —
                  the Michelson/Mach-Zehnder bench element

The integer codes are what the device kernels switch on (branchlessly).
"""

from __future__ import annotations

import enum


class Material(enum.IntEnum):
    MIRROR = 0
    REFRACTIVE = 1
    TERMINATOR = 2
    MEASURE = 3
    BEAMSPLITTER = 4
    POLARIZER = 5   # ideal linear polarizer along the element's `axis`
    WAVEPLATE = 6   # linear retarder: fast axis = `axis`, delta = retardance
    GRATING = 7     # reflection grating: groove-perpendicular = `axis`,
    #                 period = grating_period [um], fixed grating_order
    DIFFUSE = 8     # Lambertian scatterer: cosine-weighted reflection,
    #                 albedo = `reflectivity` (stray-light analysis)
    BIREFRINGENT = 9  # uniaxial crystal: o/e double refraction with
    #                 Poynting walk-off; `ior` = n_o, `ne` = n_e, `axis` =
    #                 optic axis. Requires TraceConfig(polarization=True)
    #                 (the o/e split is a Stokes projection)

    @staticmethod
    def from_any(value) -> "Material":
        """Coerce a Material, int code, or reference-style string."""
        if isinstance(value, Material):
            return value
        if isinstance(value, (int,)):
            return Material(value)
        if isinstance(value, str):
            key = value.strip().lower()
            aliases = {
                "mirror": Material.MIRROR,
                "reflective": Material.MIRROR,
                "refractive": Material.REFRACTIVE,
                "dielectric": Material.REFRACTIVE,
                "lens": Material.REFRACTIVE,
                "terminator": Material.TERMINATOR,
                "absorber": Material.TERMINATOR,
                "absorbing": Material.TERMINATOR,
                "measure": Material.MEASURE,
                "measurement": Material.MEASURE,
                "detector": Material.MEASURE,
                "beamsplitter": Material.BEAMSPLITTER,
                "splitter": Material.BEAMSPLITTER,
                "polarizer": Material.POLARIZER,
                "waveplate": Material.WAVEPLATE,
                "retarder": Material.WAVEPLATE,
                "grating": Material.GRATING,
                "diffuse": Material.DIFFUSE,
                "lambertian": Material.DIFFUSE,
                "scatterer": Material.DIFFUSE,
                "birefringent": Material.BIREFRINGENT,
                "uniaxial": Material.BIREFRINGENT,
                "crystal": Material.BIREFRINGENT,
            }
            if key in aliases:
                return aliases[key]
            raise ValueError(f"unknown material name: {value!r}")
        raise TypeError(f"cannot coerce {type(value)} to Material")


# Convenience string constants matching the reference's material vocabulary.
MIRROR = Material.MIRROR
REFRACTIVE = Material.REFRACTIVE
TERMINATOR = Material.TERMINATOR
MEASURE = Material.MEASURE
BEAMSPLITTER = Material.BEAMSPLITTER
POLARIZER = Material.POLARIZER
WAVEPLATE = Material.WAVEPLATE
GRATING = Material.GRATING
DIFFUSE = Material.DIFFUSE
BIREFRINGENT = Material.BIREFRINGENT


# Wavelengths of the standard Fraunhofer lines used for dispersion specs [um]
D_LINE = 0.5876   # helium d (yellow) — indices are quoted at this line
F_LINE = 0.4861   # hydrogen F (blue)
C_LINE = 0.6563   # hydrogen C (red)


def glass(n_d: float, abbe: float) -> tuple:
    """Cauchy (A, B) coefficients for a glass given its d-line index and
    Abbe number V_d = (n_d - 1) / (n_F - n_C).

    Returns (ior, dispersion_b) to pass to a refractive GeoObject:
        n(wl) = ior + dispersion_b / wl^2     (wl in micrometers).
    Dispersion is an extension over the reference (which has a single
    constant IOR per element); dispersion_b = 0 reproduces it exactly.
    """
    if abbe <= 0:
        raise ValueError("Abbe number must be positive")
    spread = 1.0 / F_LINE**2 - 1.0 / C_LINE**2
    b = (n_d - 1.0) / (abbe * spread)
    a = n_d - b / D_LINE**2
    return a, b


# a few catalog glasses (n_d, V_d)
BK7 = glass(1.5168, 64.17)
SF10 = glass(1.7280, 28.53)
F2 = glass(1.6200, 36.37)


# Sellmeier dispersion of real catalog glasses:
#     n^2(wl) = 1 + sum_i B_i wl^2 / (wl^2 - C_i),   wl in micrometers,
# the standard (B1..B3, C1..C3) form optical catalogs publish. Values are
# the widely-published Schott catalog / Malitson fused-silica constants.
SELLMEIER = {
    "N-BK7": ((1.03961212, 0.231792344, 1.01046945),
              (0.00600069867, 0.0200179144, 103.560653)),
    "N-SF10": ((1.62153902, 0.256287842, 1.64447552),
               (0.0122241457, 0.0595736775, 147.468793)),
    "N-SF11": ((1.73759695, 0.313747346, 1.89878101),
               (0.013188707, 0.0623068142, 155.23629)),
    "F2": ((1.34533359, 0.209073176, 0.937357162),
           (0.00997743871, 0.0470450767, 111.886764)),
    "N-BAF10": ((1.5851495, 0.143559385, 1.08521269),
                (0.00926681282, 0.0424489805, 105.613573)),
    "N-SK16": ((1.34317774, 0.241144399, 0.994317969),
               (0.00704687339, 0.0229005, 92.7508526)),
    "FUSED-SILICA": ((0.6961663, 0.4079426, 0.8974794),
                     (0.0046791483, 0.0135120631, 97.9340025)),
    # round 4 additions — every entry is verified against the glass's
    # published (n_d, V_d) in tests/test_dispersion.py (d-line index to
    # 5e-4, Abbe number to 0.5), so a transcription typo cannot ship
    "N-SF5": ((1.52481889, 0.187085527, 1.42729015),
              (0.011254756, 0.0588995392, 129.141675)),
    "N-SF6": ((1.77931763, 0.338149866, 2.08734474),
              (0.0133714182, 0.0617533621, 174.01759)),
    "N-BAK4": ((1.28834642, 0.132817724, 0.945395373),
               (0.00779980626, 0.0315631177, 105.965875)),
    "N-FK51A": ((0.971247817, 0.216901417, 0.904651666),
                (0.00472301995, 0.0153575612, 168.68133)),
    "N-K5": ((1.08511833, 0.199562005, 0.930511663),
             (0.00661099503, 0.024110866, 111.982777)),
    "N-LAK22": ((1.14229781, 0.535138441, 1.04088385),
                (0.00585778594, 0.0198546147, 100.834017)),
    "N-SSK5": ((1.59222659, 0.103520774, 1.05174016),
               (0.00920284626, 0.0423530072, 106.927374)),
    "N-LASF9": ((2.00029547, 0.298926886, 1.80691843),
                (0.0121426017, 0.0538736236, 156.530829)),
}

# published catalog (n_d, V_d) of every SELLMEIER glass — the
# transcription-check anchor (tests/test_dispersion.py) and a convenient
# lookup for paraxial chromatic design (paraxial.seidel / io.zmx)
PUBLISHED_ND_VD = {
    "N-BK7": (1.5168, 64.17),
    "N-SF10": (1.72828, 28.53),
    "N-SF11": (1.7847, 25.68),
    "F2": (1.6200, 36.37),
    "N-BAF10": (1.6700, 47.11),
    "N-SK16": (1.6204, 60.32),
    "FUSED-SILICA": (1.4585, 67.8),
    "N-SF5": (1.67271, 32.25),
    "N-SF6": (1.80518, 25.36),
    "N-BAK4": (1.56883, 55.98),
    "N-FK51A": (1.48656, 84.47),
    "N-K5": (1.52249, 59.48),
    "N-LAK22": (1.65113, 55.89),
    "N-SSK5": (1.65844, 50.88),
    "N-LASF9": (1.85025, 32.17),
}


def sellmeier_index(wl_um, coeffs):
    """Exact Sellmeier index n(wl). `coeffs` is a SELLMEIER key or a
    ((B1, B2, B3), (C1, C2, C3)) pair; `wl_um` a scalar or numpy array of
    vacuum wavelengths in micrometers."""
    import numpy as np

    if isinstance(coeffs, str):
        coeffs = SELLMEIER[coeffs]
    b, c = coeffs
    wl2 = np.asarray(wl_um, np.float64) ** 2
    n2 = 1.0 + sum(bi * wl2 / (wl2 - ci) for bi, ci in zip(b, c))
    return np.sqrt(n2)


def glass_from_sellmeier(coeffs, band=(0.4, 0.7), n_samples=129) -> dict:
    """Fit a Sellmeier glass to the tracer's extended-Cauchy model
    n = A + B/wl^2 + C/wl^4 by least squares over `band` [um].

    Returns {"ior": A, "dispersion_b": B, "dispersion_c": C} ready to
    splat into a refractive GeoObject / primitive factory:

        oe.prism(..., material="refractive",
                 **glass_from_sellmeier("N-SF10"))

    Fit quality over the full visible band (0.4-0.7 um): ~7e-5 max
    index error for crowns / fused silica, ~3e-4 for the densest flints
    (N-SF11) — an order better than the two-term `glass()` helper. Over
    the photopic core (0.48, 0.66) every catalog glass fits to ~4e-5 or
    better, so narrow `band` to your source's spectrum when it matters.
    Residuals above 5e-4 raise so a bad band cannot silently mis-model
    a glass.
    """
    import numpy as np

    wl = np.linspace(band[0], band[1], n_samples)
    n = sellmeier_index(wl, coeffs)
    design = np.stack([np.ones_like(wl), wl**-2.0, wl**-4.0], axis=1)
    (a, b, c), *_ = np.linalg.lstsq(design, n, rcond=None)
    err = np.abs(design @ np.array([a, b, c]) - n).max()
    if err > 5e-4:
        raise ValueError(
            f"extended-Cauchy fit residual {err:.2e} over band {band} — "
            "band too wide for the lambda^-4 model (fit a narrower band "
            "per trace, or trace per-wavelength with exact indices)")
    return {"ior": float(a), "dispersion_b": float(b),
            "dispersion_c": float(c)}


# complex refractive indices (n, k) of common mirror metals near the
# sodium d-line (~0.55-0.59 um; Johnson & Christy / Palik order of
# magnitude). Pass to a MIRROR GeoObject: metal_n, metal_k = ALUMINUM.
ALUMINUM = (0.96, 6.69)
SILVER = (0.13, 3.99)
GOLD = (0.34, 2.69)
COPPER = (0.62, 2.57)


# principal indices (n_o, n_e) of common uniaxial crystals near the sodium
# d-line. Pass to a BIREFRINGENT GeoObject: ior, ne = CALCITE (calcite and
# sapphire are negative uniaxial, n_e < n_o; quartz and MgF2 positive).
CALCITE = (1.658, 1.486)
QUARTZ = (1.5443, 1.5534)
SAPPHIRE = (1.768, 1.760)
MGF2 = (1.3777, 1.3895)
