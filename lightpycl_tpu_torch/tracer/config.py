"""Trace configuration.

Port counterpart of lightpycl_tpu/tracer/config.py: the same frozen
dataclass with the same fields and defaults (tests/test_torch_host_layer.py
pins them). Only the meaning of `backend` differs: "auto" launches the
CUDA kernel for CUDA tensors and the plain torch version for CPU tensors,
"cuda" always the kernel (raises on CPU), "torch" always the plain version.

Reference parity: the kwargs of CL_Tracer.iterative_tracer(...) —
trace_iterations, max_ray_len, ior_env, power-dissipation cutoff
(SURVEY.md §3 "CL_Tracer"). Kept as a frozen (hashable) dataclass so it can
be a static argument to jitted trace steps; no CLI/flag framework, matching
the reference's library-not-app character (SURVEY.md §5.6).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static trace parameters.

    Attributes:
      trace_iterations: fixed trace depth (bounces) per run
      max_ray_len:      rays miss beyond this distance (drawn to this length
                        and terminated, like the reference). The engine
                        auto-expands the DEFAULT when the scene + source
                        reach exceeds it (telescope-scale imports); an
                        explicitly set value is always respected
      ior_env:          ambient index of refraction
      eps:              self-intersection guard: hits require t > eps
                        (world units; the reference's kernel epsilon)
      eps_bary:         barycentric-coordinate edge tolerance
      power_cutoff:     rays with power below this are culled at compaction
                        (their power is accounted as 'culled' so energy
                        conservation stays exact)
      dissipation_target: host-loop early exit once
                        (measured+absorbed+escaped+culled) / emitted exceeds
                        this fraction (reference: power-dissipation cutoff)
      hist_azimuth_bins / hist_polar_bins: detector histogram shape
      hist_mode:        'position'  — bin spherical angles of the hit point
                        relative to `hist_center` (hemisphere detector
                        directivity, the reference's analysis);
                        'direction' — bin the arriving ray direction
      hist_center:      center the 'position' histogram binning about this
                        point (default origin — set it to the detector
                        dome's center for off-origin detectors, or the
                        directivity histogram silently skews)
      tri_chunk:        triangle tile size for the jnp intersect scan
      backend:          'auto' | 'cuda' | 'torch' intersect implementation
      allow_splitting:  False skips the refracted-child slots and the 2C
                        compaction entirely (valid when the scene has no
                        refractive elements; the engine sets this
                        automatically from the scene materials)
      compaction:       'topk'   — keep the C highest-power live children
                                   (the reference-faithful drop policy);
                        'stream' — cumsum stream compaction, O(C) instead
                                   of a sort; identical result unless the
                                   2C->C selection overflows, where it
                                   drops by slot order instead of power
    """

    trace_iterations: int = 8
    max_ray_len: float = 1e3
    ior_env: float = 1.0
    eps: float = 1e-4
    eps_bary: float = 1e-6
    power_cutoff: float = 0.0
    dissipation_target: float = 0.999
    hist_azimuth_bins: int = 36
    hist_polar_bins: int = 18
    hist_mode: str = "position"
    hist_center: tuple = (0.0, 0.0, 0.0)
    tri_chunk: int = 512
    backend: str = "auto"
    allow_splitting: bool = True
    compaction: str = "topk"
    # conservative block x tile culling in the Pallas kernel: identical
    # intersect results to brute force (the mask only skips provably
    # unreachable block x tile cells), 2.9-3.2x end-to-end on coherent
    # scenes. None (default) = AUTO: the engine enables it when the
    # source bundle is coherent enough for the mask to bite (cheap
    # min-cosine test on the sampled directions, see
    # Tracer._resolve_cull) and disables it otherwise. Ray count never
    # gates it: past the SMEM mask budget intersect_pallas slices the
    # ray axis into chunks whose masks fit at the tuned block/tile rung
    # (ops.intersect_pallas.cull_ray_chunk — without it the kernel
    # self-disables to brute while still paying the Morton sort, which
    # measured BELOW brute at 16M rays on v5e). True/False force it
    # (the kernel's SMEM self-disable stays as the correctness backstop
    # for direct _intersect_pallas_impl callers). Direct step.trace_step
    # users: None behaves as False.
    # Note the per-bounce Morton reorder changes scatter-add ORDER, so
    # detector sums may differ from the brute path at fp-reassociation
    # level (~1e-7 relative) — physics identical.
    cull: bool | None = None
    # opt-in Stokes-Mueller polarization: polarized Fresnel coefficients,
    # TIR retardation, frame tracking. Off (default) = the reference's
    # unpolarized scalar model, R = (Rs+Rp)/2 at every surface.
    polarization: bool = False
    # opt-in Russian-roulette termination of weak rays: children below this
    # power threshold survive with probability power/threshold (boosted to
    # the threshold) — unbiased, unlike power_cutoff. `seed` feeds the
    # per-bounce PRNG.
    roulette_threshold: float = 0.0
    # True computes the reflection-grating branch in shade for every ray
    # (safe default for direct step users); the engine sets it False when
    # the scene has no GRATING elements — the branchless math costs ~7% of
    # a full trace otherwise
    has_gratings: bool = True
    # True computes the thin-film R(lambda, theta) branch (multilayer
    # stacks supported) for every dielectric hit (safe default for direct
    # step users with coated elements); the engine sets it False when no
    # element has a coating. Under polarization=True the coated lanes use
    # the characteristic-matrix Mueller split (physics.polarized_film_split)
    # instead of the scalar Airy recursion.
    has_coatings: bool = True
    # True enables the Lambertian-scatter branch (Material.DIFFUSE), which
    # DRAWS RANDOM NUMBERS: trace_step then requires a PRNG key, so unlike
    # the other has_* flags this one defaults OFF and the engine switches
    # it on when the scene contains diffuse elements.
    has_diffuse: bool = False
    # True computes the metallic-Fresnel mirror branch (complex-index
    # mirrors, GeoObject.metal_n/metal_k) for every mirror hit. Defaults
    # True — like has_gratings, a metal scene traced through the raw step
    # API must not silently fall back to ideal mirrors — and the engine
    # (and diff's loss factories) switch it off when no metals exist
    has_metals: bool = True
    # True computes the uniaxial-crystal branch (Material.BIREFRINGENT:
    # o/e double refraction with Poynting walk-off) for every hit under
    # polarization=True. Defaults True like has_gratings — a crystal scene
    # traced through the raw step API must not silently absorb — and the
    # engine switches it off when no birefringent elements exist. The
    # branch only activates when the scene carries the `bire_ne` column
    # AND cfg.polarization is set (the o/e split is a Stokes projection;
    # unpolarized traces absorb crystal hits, ledger-exact).
    has_birefringence: bool = True
    # True enables VOLUME scattering (GeoObject.scattering > 0: turbid
    # dielectric bulk — free paths ~ Exp(mu_s), Henyey-Greenstein redraw).
    # Draws random numbers, so like has_diffuse it defaults OFF and the
    # engine switches it on when the scene contains turbid elements.
    has_scattering: bool = False
    # True enables FLUORESCENCE (GeoObject.fluorescence > 0: phosphor
    # conversion events — Exp(mu_f) free paths below the band edge,
    # isotropic re-emission at an inverse-CDF-sampled wavelength, QY x
    # Stokes-shift power factor, remainder absorbed). Auto-enabled by the
    # engine like has_scattering. Needs the scene REPLICATED (the
    # per-element emission tables index by rays.medium), so the engine
    # refuses mode='mesh2d' and coherent/spectral combinations.
    has_fluorescence: bool = False
    # True enables rough-mirror surface scatter (GeoObject.roughness > 0:
    # Rayleigh-Rice TIS split into a specular child and an HG-lobe
    # scattered child). The SPLIT is deterministic; only the scattered
    # direction draws randomness. Auto-enabled by the engine.
    has_roughness: bool = False
    # True enables gradient-index propagation (GeoObject.grin_a != 0:
    # rays inside advance by exact closed-form SELFOC steps of `grin_step`
    # arc length
    # instead of straight segments). DETERMINISTIC — no RNG. Auto-enabled
    # by the engine, which also derives grin_step when left at 0 (a
    # fraction of the shortest profile pitch). Needs the scene replicated
    # (per-element tables): mesh2d is refused.
    has_grin: bool = False
    # True runs the exact quadric intersector (geometry/analytic.py
    # surfaces: ops/quadric.py) after each triangle intersect and merges
    # the nearest hit. DETERMINISTIC, no RNG. Auto-enabled by the engine
    # when the scene contains AnalyticSurface elements; needs the scene
    # replicated (mesh2d is refused).
    has_analytic: bool = False
    grin_step: float = 0.0  # curved-step arc length inside GRIN media;
    #   each
    #   step costs one trace iteration, so trace_iterations must cover
    #   path_length / grin_step plus the ordinary surface bounces
    grin_substeps: int = 1  # curved sub-steps taken per trace ITERATION
    #   for rays inside a GRIN medium: between sub-steps the ray
    #   re-intersects only the GRIN elements' own surfaces (a compact
    #   Tg-triangle set, scene.grin_wu/..), so k sub-steps cost
    #   k x (C x Tg) instead of k full (C x T_scene) intersects — a large
    #   win for long rods inside big scenes. trace_iterations then only
    #   needs to cover path_length / (grin_substeps * grin_step).
    #   ASSUMPTION (the single exactness caveat): nothing else intrudes
    #   into a GRIN element's interior — mid-medium sub-steps check
    #   distance to GRIN surfaces only, so an embedded foreign element
    #   would be stepped over. 1 (default) = the always-exact behavior
    #   where every step pays a full-scene intersect.
    seed: int = 0
    # optional on-device planar intensity image of measured hit points
    # (BASELINE configs[1] focal-plane map at mega-ray scale): an
    # image_bins x image_bins grid on the plane through image_center with
    # normal image_normal, extent +-image_halfwidth. 0 bins = disabled.
    image_bins: int = 0
    image_center: tuple = (0.0, 0.0, 0.0)
    image_normal: tuple = (0.0, 0.0, 1.0)
    image_halfwidth: float = 1.0
    # coherent imaging (extension — the reference is pure incoherent ray
    # power): alongside the incoherent `image`, accumulate the complex
    # field amplitude sqrt(P) * exp(i 2 pi OPL / lambda) of every measured
    # ray into the image grid (DetectorState.image_amp). |A|^2 per pixel
    # is the interference pattern (Michelson fringes, Newton's rings);
    # phase uses the fractional part of OPL/lambda so f32 stays exact over
    # many-wave path lengths. UNITS: OPL accumulates in scene units and
    # the phase divides it by the ray's carried wavelength directly, so
    # express the scene in the same unit as the wavelengths (um) — or
    # equivalently pass wavelengths in scene units; only the ratio enters.
    # A SCALAR coherent trace superposes every measured ray into one
    # plane — monochromatic physics (rays of different wavelengths would
    # wrongly interfere; keep the batch single-wavelength). SPECTRAL
    # coherent runs (Tracer.trace_spectral + coherent=True) instead keep
    # per-wavelength field planes (TraceResult.image_amp_spectral) and
    # sum the per-plane intensities — the physically correct white-light
    # pattern with its coherence envelope. Requires image_bins > 0.
    coherent: bool = False
    # time-resolved detection (extension — pulse response / time-of-flight):
    # measured power additionally bins by the arriving ray's accumulated
    # OPTICAL PATH LENGTH into a (D, time_bins) per-detector histogram
    # (DetectorState.time_hist). OPL = sum n * geometric length, so bin i
    # spans OPL in [opl_min + i*dt, ...) with dt = (opl_max - opl_min) /
    # time_bins — divide by c in your unit system for seconds. Arrivals
    # outside [opl_min, opl_max) clamp into the edge bins so total power
    # is preserved (sum(time_hist) == measured). 0 bins = disabled.
    time_bins: int = 0
    opl_min: float = 0.0
    opl_max: float = 0.0
    # per-facet incident-flux map (extension — illumination design): every
    # valid surface hit scatter-adds the ARRIVING parent power into a
    # per-triangle accumulator (DetectorState.tri_flux), regardless of
    # material. analysis.surface_flux divides by facet area to give the
    # irradiance map; per-element totals aggregate it. Note this is a flux
    # map, not a conservation ledger: a ray refracting through two lens
    # faces deposits its power on BOTH facets. Needs the scene replicated
    # (triangle indices are global): mesh2d is refused; spectral traces do
    # not support it yet.
    flux_map: bool = False
    # detector-accumulation formulation. 'scatter' = XLA .at[].add (sort-
    # based segmented reduce); 'mxu' = chunked one-hot matmuls on the MXU
    # (one one-hot per index array, shared by all weight rows). 'auto'
    # picks MXU on TPU for small-bin surfaces (angular hist, per-detector,
    # image, time-of-flight) and scatter elsewhere (CPU; the per-triangle
    # flux map, whose bin count ~ scene size would make the one-hot FLOPs
    # rival the intersect itself). Measured at 4M rays x 648 bins on v5e:
    # MXU 7.3 ms vs scatter 78.5 ms (10.7x) AND closer to the f64 sum
    # (3.8e-7 vs 1.1e-4 — the MXU's chunked accumulation orders the f32
    # adds better than the segmented scatter), benchmarks/detector_bench.py
    # -> results/detector_epilogue_v5e_r4.jsonl. Physics identical either
    # way; sums differ at fp-reassociation level.
    detector_accum: str = "auto"
    # ghost / stray-light path tracking (extension): every surviving child
    # appends a digit (element index, reflected-or-transmitted branch) to
    # its f32 path signature in base path_base = 2 * n_elements + 1; the
    # measured-ray harvest (host mode) carries the signature out, and
    # analysis.ghost_paths decodes + ranks the power by path. Signatures
    # are exact while path_base^bounces < 2^24 (f32 integer range) —
    # beyond that they degrade to collision-unlikely lossy grouping.
    # The engine sets path_base from the scene; host mode only.
    track_paths: bool = False
    path_base: int = 0

    @property
    def needs_rng(self) -> bool:
        """True when the trace step draws random numbers (roulette,
        Lambertian surface scatter, volume scattering, fluorescence,
        and/or rough-mirror lobes) and therefore needs a PRNG key per
        bounce."""
        return (self.roulette_threshold > 0.0 or self.has_diffuse
                or self.has_scattering or self.has_fluorescence
                or self.has_roughness)

    def replace(self, **kw) -> "TraceConfig":
        return dataclasses.replace(self, **kw)
