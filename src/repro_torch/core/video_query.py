"""The ACE intelligent video query application (paper §5).

Components (§5.1.2): DG (data generator), OD (frame-differencing object
detector), EOC (edge object classifier), COC (cloud object classifier),
IC (in-app controller with BP/AP), RS (result storage). Deployed through the
regular ACE pipeline: topology file -> orchestrator -> controller -> agents.

Crops are produced by a *crop bank*: either a statistical surrogate
calibrated to the paper's model qualities (EOC 11.06% error @ 0.8
confidence, COC 4.49% top-5 error) for the Fig. 5 sweep, or real CNN
predictions precomputed in one batched pass on the device
(``repro_torch.data.video.model_crop_bank``) for the end-to-end example.
Ground truth for F1 follows the paper's footnote: COC's post-hoc
classification of every extracted crop.

Implementation paradigms compared (§5.2): CI (COC only), EI (EOC only),
ACE (cascade + BP), ACE+ (cascade + AP).
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional

from repro_torch.configs.ace_video_query import VideoQueryConfig
from repro_torch.core.inapp.policies import AdvancedPolicy, BasicPolicy
from repro_torch.core.registry import image
from repro_torch.core.sim import SimClock
from repro_torch.core.topology import Component, Resources, Topology


# ---------------------------------------------------------------------------
# Crop bank
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Crop:
    crop_id: int
    positive_gt: bool       # COC post-hoc label (the paper's F1 ground truth)
    eoc_conf: float         # EOC max-softmax confidence
    eoc_pred: int           # EOC binary prediction (1 = target class)
    coc_hit: bool           # COC online top-5 contains the target label
    nbytes: int = 12_000


def surrogate_crop_bank(n: int, *, seed: int = 0, positive_rate: float = 0.12,
                        eoc_error: float = 0.1106, coc_top5_err: float = 0.0449,
                        online_flip: float = 0.02,
                        crop_bytes: int = 12_000) -> List[Crop]:
    """Statistical surrogate calibrated to paper §5.1.2 model qualities."""
    rng = random.Random(seed)
    crops = []
    for i in range(n):
        true_pos = rng.random() < positive_rate
        # COC online agrees with its own post-hoc labelling up to small
        # input-pipeline variation (resize/JPEG), which is what keeps CI's
        # F1 slightly below 1.0 in the paper.
        coc_correct = rng.random() >= coc_top5_err
        coc_posthoc_pos = true_pos if coc_correct else not true_pos
        coc_hit = (coc_posthoc_pos if rng.random() >= online_flip
                   else not coc_posthoc_pos)
        # EOC confidence: correct crops skew high, wrong crops mid-band
        eoc_correct = rng.random() >= eoc_error
        eoc_pred = int(true_pos if eoc_correct else not true_pos)
        if eoc_correct:
            conf = min(0.999, max(0.02, rng.betavariate(8.0, 1.0)))
        else:
            conf = min(0.999, max(0.02, rng.betavariate(2.5, 2.5)))
        crops.append(Crop(i, coc_posthoc_pos, conf, eoc_pred, coc_hit,
                          crop_bytes))
    return crops


# ---------------------------------------------------------------------------
# Serving-engine-backed classifier calibration
# ---------------------------------------------------------------------------

def calibrate_server_from_engine(engine, *, n_queries: int = 8,
                                 prompt_len: int = 12, max_new: int = 4,
                                 seed: int = 0) -> dict:
    """Measure a continuous-batching ``ServingEngine``'s service profile so
    the simulated EOC/COC servers run at the rate the real engine delivers
    (the ACE cascade application "running on" the serving layer).

    Returns {"service_s", "workers", "tokens_s"}: mean per-query seconds at
    the offered concurrency, the engine's slot count (simulated as FIFO
    workers), and raw decode throughput.
    """
    import numpy as np
    rng = np.random.default_rng(seed)
    vocab = engine.lm.cfg.vocab_size
    # warm the compile caches so calibration measures steady-state service
    engine.submit(rng.integers(0, vocab, size=prompt_len), max_new)
    engine.run()
    t0 = time.perf_counter()
    for _ in range(n_queries):
        engine.submit(rng.integers(0, vocab, size=prompt_len), max_new)
    done = engine.run()
    wall = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done.values())
    # wall is measured at full slot concurrency; service_s is per *worker*
    # so that a Server with ``workers`` slots reproduces the engine's
    # aggregate throughput (n_queries / wall), not ``workers``× it
    return {"service_s": wall * engine.batch_slots / n_queries,
            "workers": engine.batch_slots,
            "tokens_s": toks / max(wall, 1e-9)}


# ---------------------------------------------------------------------------
# A multi-worker FIFO server (classifier compute model)
# ---------------------------------------------------------------------------

class Server:
    def __init__(self, clock: SimClock, service_s: float, workers: int = 1,
                 max_backlog_s: Optional[float] = None):
        self.clock = clock
        self.service_s = service_s
        self.workers = workers
        self.max_backlog_s = max_backlog_s
        self._free_at = [0.0] * workers
        self.served = 0
        self.dropped = 0

    def submit(self, fn, on_drop=None) -> Optional[float]:
        """Queue one item; run ``fn`` at completion. Items past the backlog
        bound are dropped (the paper's 'queue backlog at EOC' under BP)."""
        if (self.max_backlog_s is not None
                and self.backlog_s > self.max_backlog_s):
            self.dropped += 1
            if on_drop is not None:
                on_drop()
            return None
        i = min(range(self.workers), key=lambda j: self._free_at[j])
        start = max(self.clock.now, self._free_at[i])
        done = start + self.service_s
        self._free_at[i] = done
        self.served += 1
        self.clock.schedule_at(done, fn)
        return done

    @property
    def backlog_s(self) -> float:
        return max(0.0, min(self._free_at) - self.clock.now)


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------

@image("repro/video-query/dg")
class DataGenerator:
    """Provides the real-time video stream to its edge node (paper DG)."""

    def __init__(self, frame_interval_s: float = 0.5, duration_s: float = 60.0,
                 camera: str = "cam"):
        self.frame_interval_s = frame_interval_s
        self.duration_s = duration_s
        self.camera = camera

    def start(self, ctx) -> None:
        self.ctx = ctx
        # desynchronize cameras: deterministic per-instance phase offset
        import hashlib
        h = int(hashlib.md5(ctx.instance_id.encode()).hexdigest()[:8], 16)
        self.phase = (h % 9973) / 9973.0 * self.frame_interval_s
        self._emit(0)

    def _emit(self, idx: int) -> None:
        t = self.phase + idx * self.frame_interval_s
        if t >= self.duration_s:
            return
        self.ctx.clock.schedule_at(t, lambda: self._frame(idx))

    def _frame(self, idx: int) -> None:
        self.ctx.publish(f"vq/frames/{self.camera}",
                         {"camera": self.camera, "idx": idx}, nbytes=64)
        self._emit(idx + 1)


@image("repro/video-query/od")
class ObjectDetector:
    """Frame differencing: rapidly extracts crops with salient pixel
    differences (paper OD). Crop count per frame follows the bank."""

    def __init__(self, camera: str = "cam", crops_per_frame: float = 1.0,
                 proc_s: float = 0.005, seed: int = 0):
        self.camera = camera
        self.crops_per_frame = crops_per_frame
        self.proc_s = proc_s
        self.rng = random.Random(seed)
        self.emitted = 0

    def start(self, ctx) -> None:
        self.ctx = ctx
        self.app = ctx.params.get("app")
        ctx.subscribe(f"vq/frames/{self.camera}", self._on_frame)

    def _on_frame(self, msg) -> None:
        # 1 crop per sampled frame + Bernoulli extra -> mean crops_per_frame
        n = 1 + (1 if self.rng.random() < (self.crops_per_frame - 1.0) else 0)

        def emit():
            for _ in range(n):
                self.emitted += 1
                self.app.submit_crop(self.camera, self.ctx)
        self.ctx.clock.schedule(self.proc_s, emit)


@image("repro/video-query/rs")
class ResultStorage:
    def __init__(self):
        self.results: Dict[int, dict] = {}

    def start(self, ctx) -> None:
        ctx.subscribe("vq/results", self._on_result)

    def _on_result(self, msg) -> None:
        self.results[msg.payload["crop_id"]] = msg.payload


# ---------------------------------------------------------------------------
# The application: the paradigm-specific data path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QueryMetrics:
    tp: int = 0
    fp: int = 0
    fn: int = 0
    crops: int = 0
    eils: List[float] = dataclasses.field(default_factory=list)

    def f1(self) -> float:
        p = self.tp / max(self.tp + self.fp, 1)
        r = self.tp / max(self.tp + self.fn, 1)
        return 2 * p * r / max(p + r, 1e-9)

    def mean_eil(self) -> float:
        return sum(self.eils) / max(len(self.eils), 1)


class VideoQueryApp:
    """Wires the deployed components with the paradigm-specific data path.

    paradigm: 'ci' | 'ei' | 'ace' | 'ace+'  (paper §5.2)
    """

    def __init__(self, cfg: VideoQueryConfig, platform, infra, *,
                 paradigm: str, crop_bank: List[Crop], seed: int = 0,
                 eoc_service: Optional[dict] = None,
                 coc_service: Optional[dict] = None):
        self.cfg = cfg
        self.platform = platform
        self.infra = infra
        self.paradigm = paradigm
        self.bank = crop_bank
        self.rng = random.Random(seed)
        self.clock = platform.clock
        self.network = platform.network(infra)
        self.metrics = QueryMetrics()
        self._crop_ptr = 0
        # classifier servers: one EOC per EC (its x86 node), one COC at CC.
        # Service profiles default to the paper's measured ms; when a
        # serving-engine calibration dict is given (see
        # ``calibrate_server_from_engine``), the classifiers run at the
        # continuous-batching engine's measured rate and concurrency.
        eoc_s = (eoc_service or {}).get("service_s", cfg.eoc_infer_ms / 1e3)
        eoc_w = (eoc_service or {}).get("workers", 1)
        coc_s = (coc_service or {}).get("service_s", cfg.coc_infer_ms / 1e3)
        coc_w = (coc_service or {}).get("workers", 1)
        self.eoc: Dict[str, Server] = {}
        for ec in infra.ecs:
            # one x86 mini PC per EC runs EOC (paper §5.1.1); bounded queue
            self.eoc[str(ec)] = Server(self.clock, eoc_s, workers=eoc_w,
                                       max_backlog_s=1.0)
        self.coc = Server(self.clock, coc_s, workers=coc_w)
        if paradigm == "ace+":
            self.policy = AdvancedPolicy(cfg.accept_threshold,
                                         cfg.drop_threshold,
                                         deteriorate_s=0.6, shrink=0.08)
        else:
            self.policy = BasicPolicy(cfg.accept_threshold,
                                      cfg.drop_threshold)

    # -- crop path ------------------------------------------------------------
    def submit_crop(self, camera: str, ctx) -> None:
        crop = self.bank[self._crop_ptr % len(self.bank)]
        self._crop_ptr += 1
        self.metrics.crops += 1
        born = self.clock.now
        ec = ctx.cluster
        if self.paradigm == "ci":
            self._to_coc(crop, ec, born)
            return
        if self.paradigm == "ace+" and self.policy.upload_target(self.clock.now) == "coc":
            self._to_coc(crop, ec, born)     # AP load balancing OD->COC
            return
        self._to_eoc(crop, ec, born)

    def _to_eoc(self, crop: Crop, ec, born: float) -> None:
        # LAN hop camera-node -> x86 node, then EOC queue (bounded: crops
        # past the backlog limit are dropped, the paper's BP failure mode)
        def arrived():
            server = self.eoc[str(ec)]

            def done():
                self._after_eoc(crop, ec, born)

            def dropped():
                # a drop is the strongest deterioration signal
                self.policy.observe_eil("eoc", 2.0 * server.backlog_s,
                                        now=self.clock.now)
                # dropped crops never receive a label -> no EIL sample
                self._finish(crop, False, born, count_eil=False)
            server.submit(done, on_drop=dropped)
        self.network.send(ec, ec, crop.nbytes, arrived)

    def _after_eoc(self, crop: Crop, ec, born: float) -> None:
        self.policy.observe_eil("eoc", self.clock.now - born,
                                now=self.clock.now)
        d = self.policy.classify_decision(crop.eoc_conf)
        if self.paradigm == "ei":
            # EI has no cloud: the escalation band is dropped (paper §5.2)
            positive = (d.route == "accept" and crop.eoc_pred == 1)
            self._finish(crop, positive, born)
            return
        if d.route == "accept":
            positive = crop.eoc_pred == 1
            if positive:
                self._send_metadata(ec)
            self._finish(crop, positive, born)
        elif d.route == "drop":
            self._finish(crop, False, born)
        else:
            self._to_coc(crop, ec, born, escalated=True)

    def _to_coc(self, crop: Crop, ec, born: float,
                escalated: bool = False) -> None:
        def arrived():
            def done():
                self.policy.observe_eil("coc", self.clock.now - born,
                                        now=self.clock.now)
                self._finish(crop, crop.coc_hit, born)
            self.coc.submit(done)
        self.network.send(ec, self.infra.cc, crop.nbytes, arrived)

    def _send_metadata(self, ec) -> None:
        self.network.send(ec, self.infra.cc, 200, lambda: None)

    def _finish(self, crop: Crop, predicted_positive: bool,
                born: float, count_eil: bool = True) -> None:
        if count_eil:
            self.metrics.eils.append(self.clock.now - born)
        if predicted_positive and crop.positive_gt:
            self.metrics.tp += 1
        elif predicted_positive:
            self.metrics.fp += 1
        elif crop.positive_gt:
            self.metrics.fn += 1


def video_query_topology(cfg: VideoQueryConfig, app_obj: VideoQueryApp,
                         duration_s: float,
                         frame_interval_s: float) -> Topology:
    """The topology file of paper Fig. 4, parameterized by the experiment."""
    comps = {
        "dg": Component(
            name="dg", image="repro/video-query/dg", placement="edge",
            replicas="per_label", labels=["camera"],
            resources=Resources(cpu=0.2, memory_mb=128),
            connections=["od"],
            params={"init": {"frame_interval_s": frame_interval_s,
                             "duration_s": duration_s}}),
        "od": Component(
            name="od", image="repro/video-query/od", placement="edge",
            replicas="per_label", labels=["camera"],
            resources=Resources(cpu=0.5, memory_mb=256),
            connections=["eoc", "coc", "ic"],
            params={"init": {}, "app": app_obj}),
        "eoc": Component(
            name="eoc", image="repro/video-query/rs", placement="edge",
            replicas="per_ec", resources=Resources(cpu=2.0, memory_mb=1024),
            connections=["ic", "coc"], params={"init": {}}),
        "coc": Component(
            name="coc", image="repro/video-query/rs", placement="cloud",
            resources=Resources(cpu=8.0, memory_mb=8192, accelerator=True),
            connections=["rs"], params={"init": {}}),
        "ic": Component(
            name="ic", image="repro/video-query/rs", placement="edge",
            replicas="per_ec", resources=Resources(cpu=0.2, memory_mb=128),
            connections=[], params={"init": {}}),
        "rs": Component(
            name="rs", image="repro/video-query/rs", placement="cloud",
            resources=Resources(cpu=0.5, memory_mb=512),
            connections=[], params={"init": {}}),
    }
    return Topology(app="video-query", version=1, components=comps)


def run_video_query(cfg: VideoQueryConfig, *, paradigm: str,
                    frame_interval_s: float, wan_delay_ms: float,
                    duration_s: float = 60.0, crop_bank=None,
                    seed: int = 0, eoc_engine=None, coc_engine=None) -> dict:
    """Deploy and run one (paradigm, load, delay) cell of Fig. 5.

    ``eoc_engine``/``coc_engine``: optional continuous-batching
    ``ServingEngine`` instances; when given, the simulated classifiers are
    calibrated to the engines' measured throughput and slot concurrency.
    """
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.platform import AcePlatform

    clock = SimClock()
    platform = AcePlatform(
        clock,
        network_factory=lambda c: NetworkModel(
            c, lan_mbps=cfg.lan_mbps, uplink_mbps=cfg.uplink_mbps,
            downlink_mbps=cfg.downlink_mbps,
            wan_delay_s=wan_delay_ms / 1e3, seed=seed))
    platform.register_user("paper")
    # paper §5.1.1: 3 ECs x (1 x86 + 3 RPis with cameras), 1 GPU CC
    labels = [["x86"], ["camera"], ["camera"], ["camera"]]
    infra = platform.register_infrastructure(
        "paper", num_ecs=cfg.num_edge_clouds, nodes_per_ec=cfg.nodes_per_ec,
        edge_labels=labels)
    # only app control topics bridge the WAN; frame streams stay on
    # the EC LAN (the developer-configured service scope)
    platform.deploy_services(infra, bridged_topics=["vq/results", "app/*"])

    bank = crop_bank if crop_bank is not None else surrogate_crop_bank(
        20_000, seed=seed, crop_bytes=cfg.crop_bytes)
    eoc_service = (calibrate_server_from_engine(eoc_engine)
                   if eoc_engine is not None else None)
    coc_service = (calibrate_server_from_engine(coc_engine)
                   if coc_engine is not None else None)
    app = VideoQueryApp(cfg, platform, infra, paradigm=paradigm,
                        crop_bank=bank, seed=seed,
                        eoc_service=eoc_service, coc_service=coc_service)
    topo = video_query_topology(cfg, app, duration_s, frame_interval_s)
    rec = platform.submit_app("paper", infra, topo)
    platform.deploy_app("paper", "video-query")

    # per-camera OD/DG pairing: match instance params to their camera id
    for iid, comp, ctx in platform.instances(infra, "od"):
        comp.camera = iid.replace("od-", "cam-")
        comp.app = app
        ctx.subscribe(f"vq/frames/{comp.camera}", comp._on_frame)
    for iid, comp, ctx in platform.instances(infra, "dg"):
        comp.camera = iid.replace("dg-", "cam-")

    clock.run(until=duration_s + 120.0)
    m = app.metrics
    wan_mb = platform.network(infra).wan_bytes() / 1e6
    return {
        "paradigm": paradigm, "interval_s": frame_interval_s,
        "delay_ms": wan_delay_ms, "crops": m.crops, "f1": m.f1(),
        "bwc_mb": wan_mb, "eil_s": m.mean_eil(),
        "coc_backlog_s": app.coc.backlog_s,
        "duration_s": duration_s,
    }
