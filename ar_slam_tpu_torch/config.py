# Copied from ar_slam_tpu/config.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Configuration tree for the ar_slam_tpu engine.

The reference hard-codes several constants the survey calls out as
should-be-config (tag size 0.0635 m at ar_slam_util.hpp:318-319, initial focal
3000.0 at ar_slam_util.hpp:69, LM max iterations 50 at ar_slam_util.cpp:1004,
merge queue depth 3 at merge_detections.cpp:125-126).  Here they are one
serializable dataclass tree, with the reference values as defaults so that
default-config runs replicate reference behavior.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class CameraConfig:
    """Shared pinhole camera intrinsics configuration.

    The model is ``p = focal * (x/z, y/z)`` around the image center with two
    radial terms carried-but-disabled, exactly like the reference
    (ar_slam_util.cpp:131-172).
    """

    initial_focal: float = 3000.0  # ar_slam_util.hpp:69 "non-zero focal length"
    enable_distortion: bool = False  # reference keeps l1,l2 commented out
    # "homography": self-calibrate initial focal from square-tag homographies
    # (robust basin selection; see core/calib.py).  "fixed": reference parity.
    focal_init_mode: str = "homography"


@dataclass(frozen=True)
class SolverConfig:
    """Levenberg–Marquardt trust-region configuration (≙ ceres options,
    ar_slam_util.cpp:1001-1018)."""

    max_iterations: int = 50
    initial_lambda: float = 1e-4  # ceres initial trust-region ~ 1e4 radius
    min_lambda: float = 1e-12
    max_lambda: float = 1e32
    function_tolerance: float = 1e-6  # ceres default
    parameter_tolerance: float = 1e-8  # ceres default
    # ceres default gradient test: terminate when ||J^T r||_inf <= this
    # (Solver::Options::gradient_tolerance; complements function/parameter
    # tolerances + trust-region stall detection)
    gradient_tolerance: float = 1e-10
    # ≙ ceres minimizer_progress_to_stdout (ar_slam_util.cpp:1012): print
    # one line per LM iteration.  Host-stepped (one device call per
    # iteration instead of the fused while_loop) — debug only, slower.
    minimizer_progress_to_stdout: bool = False
    # Jacobi (column-norm) scaling of the normal equations, as ceres does.
    jacobi_scaling: bool = True
    # Reduced-system solver: "dense" Cholesky (≙ ceres DENSE_SCHUR,
    # ar_slam_util.cpp:1011) or "cg" — implicit-Schur preconditioned CG
    # (≙ ITERATIVE_SCHUR + SCHUR_JACOBI; wins at large capture counts).
    linear_solver: str = "dense"
    # measured sweet spot (see solve/lm.LMConfig): loose steps + trust
    # region beat tight CG at every benchmarked scale
    cg_tolerance: float = 0.3
    cg_max_iterations: int = 25
    # robust loss: "trivial" ≙ the reference's nullptr loss function
    # (ar_slam_util.cpp:832-836); "huber" downweights outlier observations
    # (loss_scale = Huber delta, pixels of block residual norm)
    loss: str = "trivial"
    loss_scale: float = 4.0
    # Fix the gauge of the seed capture.  The reference leaves the gauge free
    # (disabled code at ar_slam_util.cpp:776-779); off by default for parity.
    fix_first_capture: bool = False
    dtype: str = "float32"  # float32 on TPU; tests may use float64 on CPU
    # "hybrid": frontal + homography seed candidates, keep the lower-residual
    # one (robust to tag tilt).  "frontal": reference-parity heuristic only.
    seed_mode: str = "hybrid"
    # "multi": seed a new capture from ALL its observations of already-
    # initialized tags (per-anchor candidates + their quaternion/position
    # mean, scored by total anchor reprojection cost) — averaging over k
    # anchors shrinks per-hop seed error ~sqrt(k), which keeps chained BFS
    # seeding in the convergence basin at 10k-tag scale.  "single": the
    # reference's one-init_block seed (ar_slam_util.cpp:803-807; set by
    # --parity).  With one anchor the two are identical.
    seed_anchors: str = "multi"
    # Localization parity: the reference's localizeOne adds residual blocks
    # for tags ABSENT from the map too, holding their never-initialized
    # zero poses constant (ar_slam_util.cpp:950-972) — which drags the
    # pose-only solve toward garbage.  Off (default) = use only map-known
    # tags (deliberate divergence, README); on (set by --parity) = exact
    # reference behavior for A/B comparison.
    localize_unknown_tags: bool = False
    # Run the full LM only every Nth BFS wave (always on the last).  The
    # reference re-optimizes after EVERY capture (ar_slam_util.cpp:845) —
    # that is the parity default 1; larger values trade per-wave pose
    # refinement for a large batch-mapping speedup (seeding still runs
    # every wave, in the same compiled program with zero LM iterations).
    optimize_every: int = 1
    # Geometric optimize schedule on top of optimize_every: when > 1, also
    # optimize at waves 1, ceil(1*g), ceil(ceil(1*g)*g), ... — frequent
    # full solves early (where chained seed drift compounds: a fresh
    # capture seeds off a tag seeded off an earlier capture) and sparse
    # ones once the map is established.  0 (default) = fixed-stride only.
    # Large batch maps (10k tags) DIVERGE with a bare stride of 256;
    # growth 1.25 converges to the noise floor at ~50 optimizes total.
    optimize_growth: float = 0.0
    # Register-then-refine: before each flush's joint LM, solve ONLY the
    # newly added captures + their newly initialized tags against the
    # frozen established map (localize-style parameter masks; same
    # compiled program).  One badly chain-seeded batch can otherwise DRAG
    # a converged map into a bad basin that no amount of later polish
    # escapes — measured at 10k-tag scale, where a single stride-256 flush
    # blew the running cost up 350x (rmse 0.37 -> 6.9 px, permanent).
    # Pure solver scheduling: the optimum is unchanged, so this stays on
    # even in --parity mode.
    warmup_new_captures: bool = True
    # Extra LM iterations for ONE final pass after the last wave (0 = off).
    # Construction waves can run a small per-wave budget (max_iterations)
    # for throughput; the polish reuses the same compiled program via the
    # traced iteration budget, so it costs zero extra compiles.
    final_polish_iterations: int = 0


@dataclass(frozen=True)
class DetectConfig:
    """Aruco detection configuration (≙ cv::aruco detector params used at
    ar_slam_util.cpp:249-252 and aruco_detector.cpp:102-106)."""

    dictionaries: tuple[str, ...] = ("4X4_50", "5X5_100")
    min_corner_distance_rate: float = 0.1
    # cv::aruco's DEFAULT detector sweeps adaptive windows 3..23 step 10
    # (adaptiveThreshWinSizeMin/Max/Step; the reference uses default params
    # at aruco_detector.cpp:102-106) — candidates from every window
    # concatenate and duplicates suppress after decode.  A single-window
    # (23,) run is ~2.5x faster when imagery is controlled.
    adaptive_thresh_win_sizes: tuple[int, ...] = (3, 13, 23)
    adaptive_thresh_constant: float = 7.0
    min_marker_perimeter_rate: float = 0.03
    max_marker_perimeter_rate: float = 4.0
    max_candidates: int = 64  # fixed candidate budget per image (TPU static shape)
    # detection working resolution: images whose longest side exceeds this
    # are downscaled before the detector and corners rescaled back
    # (sub-pixel cost ~scale/2 px; bounds per-shape compile time and keeps
    # huge sensors on the fast compiled path).  0 = always full resolution.
    max_side: int = 0
    border_bits: int = 1
    max_hamming: dict[str, int] = field(
        default_factory=lambda: {"4X4_50": 0, "5X5_100": 2, "6X6_250": 3}
    )


@dataclass(frozen=True)
class PipelineConfig:
    """Streaming pipeline behavior (≙ component params, §2.1 of SURVEY)."""

    # ingest pacing: release at most one image per ``pub_period`` seconds
    # into the detect stage, ≙ the ImageLoader's one-image-per-tick timer
    # (image_loader.cpp:92-102,164-206; reference default 0.5 s).  0
    # disables — the batched TPU pipeline needs no throttle to keep the
    # solver fed; set 0.5 for strict reference pacing parity.
    pub_period: float = 0.0
    merge_queue_depth: int = 3  # merge_detections.cpp:125-126
    # images per pipelined stage batch (serve splits submissions into
    # batches of this size so decode of batch N+1 overlaps detect of N
    # overlaps solve of N-1, ≙ the MT component container's stage overlap,
    # ar_slam_launch.py:124-142)
    batch_size: int = 8
    expected_detector_types: tuple[str, ...] = ("aruco_4X4_50", "aruco_5X5_100")
    include_image: bool = True
    output_map_fn: str = ""
    display_debug: bool = False
    event_log_path: str = ""  # ≙ bag_recorder.cpp fixed /tmp/ar_slam.bag
    # hermetic logs: embed each capture's pixels (base64 PNG) in the event
    # log so ``arslam replay`` needs no original files, ≙ the bag storing
    # full Capture messages (bag_recorder.cpp:73-83).  Off by default —
    # detection-only replay (the recorded corners) rebuilds the same map
    # without the ~100x log size.
    event_log_embed_images: bool = False
    # periodic durable checkpoint cadence during long incremental runs
    # (map.yaml is the checkpoint format); 0 disables
    snapshot_every_s: float = 0.0
    profile_trace_dir: str = ""  # torch.profiler chrome traces (--profile)


@dataclass(frozen=True)
class DistConfig:
    """Distributed BA configuration."""

    data_axis: str = "blocks"  # mesh axis name for tag/observation sharding
    # number of devices to shard the solve over; 0 or 1 = single-device
    # (no distribution).  The CLI --devices flag sets this.
    num_devices: int = 0


@dataclass(frozen=True)
class ArSlamConfig:
    """Top-level configuration tree."""

    aruco_size: float = 0.0635  # meters; 2.5 in (ar_slam_util.hpp:318-319)
    camera: CameraConfig = field(default_factory=CameraConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    detect: DetectConfig = field(default_factory=DetectConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    dist: DistConfig = field(default_factory=DistConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ArSlamConfig":
        def build(cls, data, path=""):
            names = {f.name for f in dataclasses.fields(cls)}
            unknown = set(data) - names
            if unknown:
                raise ValueError(
                    f"unknown config key(s) {sorted(unknown)} under "
                    f"'{path or cls.__name__}'; valid: {sorted(names)}")
            kw = {}
            for f in dataclasses.fields(cls):
                if f.name not in data:
                    continue
                v = data[f.name]
                if f.name in ("camera", "solver", "detect", "pipeline",
                              "dist"):
                    v = build(_SUB[f.name], v, f.name)
                elif isinstance(v, list):
                    v = tuple(v)
                kw[f.name] = v
            return cls(**kw)

        return build(ArSlamConfig, d)


_SUB = {
    "camera": CameraConfig,
    "solver": SolverConfig,
    "detect": DetectConfig,
    "pipeline": PipelineConfig,
    "dist": DistConfig,
}

DEFAULT_CONFIG = ArSlamConfig()
