"""The port's ACE platform (``repro_torch.core``): registration ->
topology -> orchestration -> deployment -> update -> removal, the
resource-level services, the ECC processing, training and hybrid
patterns, and the orchestrator's plans against ``repro``'s. Pure Python
but ``fedavg``, which must give ``repro``'s average exactly (the same f32
products and sums)."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.core.platform import AcePlatform as JaxPlatform  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro_torch.core.ids import IdAllocator  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.orchestrator import PlanningError  # noqa: E402
from repro_torch.core.platform import AcePlatform  # noqa: E402
from repro_torch.core.pubsub import MessageService  # noqa: E402
from repro_torch.core.registry import IMAGES, image  # noqa: E402
from repro_torch.core.services.file_service import FileService  # noqa: E402
from repro_torch.core.services.object_store import ObjectStore  # noqa: E402
from repro_torch.core.sim import SimClock  # noqa: E402
from repro_torch.core.topology import Component, Resources, Topology  # noqa: E402

NULL = "test/torch-null"


class NullComponent:
    def __init__(self, **kw):
        self.kw = kw
        self.running = False

    def start(self, ctx):
        self.ctx = ctx
        self.running = True

    def stop(self):
        self.running = False


if NULL not in IMAGES:
    image(NULL)(NullComponent)


def test_image_registries_are_separate():
    """Both packages register the application's images under the same
    names, each in its own registry."""
    from repro.core.registry import IMAGES as JAX_IMAGES
    import repro_torch.core.video_query  # noqa: F401
    import repro.core.video_query  # noqa: F401
    assert IMAGES is not JAX_IMAGES
    for name in ("repro/video-query/dg", "repro/pattern/fed-worker"):
        assert IMAGES.get(name) is not JAX_IMAGES.get(name)
        assert IMAGES.get(name).__module__.startswith("repro_torch.")


def _platform():
    ace = AcePlatform()
    ace.register_user("alice")
    infra = ace.register_infrastructure(
        "alice", num_ecs=2, nodes_per_ec=3,
        edge_labels=[["x86"], ["camera"], ["camera"]])
    ace.deploy_services(infra)
    return ace, infra


def _topo(**comps):
    return Topology(app="app", version=1, components=comps)


def test_full_lifecycle():
    ace, infra = _platform()
    topo = _topo(
        worker=Component(name="worker", image=NULL, placement="edge",
                         replicas="per_ec",
                         resources=Resources(cpu=1.0, memory_mb=256)),
        head=Component(name="head", image=NULL, placement="cloud",
                       connections=["worker"]),
    )
    ace.submit_app("alice", infra, topo)
    plan = ace.deploy_app("alice", "app")
    assert len(plan.instances["worker"]) == 2          # one per EC
    assert len(plan.instances["head"]) == 1
    for inst in plan.instances["worker"]:
        assert ".ec-" in inst.node
    assert ".cc-" in plan.instances["head"][0].node
    # agents actually started the components
    assert len(ace.instances(infra, "worker")) == 2
    assert all(c.running for _, c, _ in ace.instances(infra, "worker"))
    node = infra.nodes[plan.instances["worker"][0].node]
    assert node.allocated.cpu == 1.0
    ace.remove_app("alice", "app")
    assert len(ace.instances(infra, "worker")) == 0
    assert node.allocated.cpu == 0.0


def test_label_constraint():
    ace, infra = _platform()
    topo = _topo(cam=Component(name="cam", image=NULL,
                               replicas="per_label", labels=["camera"]))
    ace.submit_app("alice", infra, topo)
    plan = ace.deploy_app("alice", "app")
    assert len(plan.instances["cam"]) == 4             # 2 ECs x 2 cam nodes
    for inst in plan.instances["cam"]:
        assert "camera" in infra.nodes[inst.node].labels


def test_unsatisfiable_resources_raise():
    ace, infra = _platform()
    topo = _topo(fat=Component(
        name="fat", image=NULL, placement="edge",
        resources=Resources(cpu=1000.0, memory_mb=1)))
    ace.submit_app("alice", infra, topo)
    with pytest.raises(PlanningError):
        ace.deploy_app("alice", "app")


def test_accelerator_constraint_pins_to_cloud():
    ace, infra = _platform()
    topo = _topo(gpu=Component(
        name="gpu", image=NULL, placement="any",
        resources=Resources(cpu=1.0, memory_mb=64, accelerator=True)))
    ace.submit_app("alice", infra, topo)
    plan = ace.deploy_app("alice", "app")
    assert ".cc-" in plan.instances["gpu"][0].node


def test_incremental_update():
    ace, infra = _platform()
    c = lambda name, cpu: Component(name=name, image=NULL,  # noqa: E731
                                    resources=Resources(cpu=cpu,
                                                        memory_mb=64))
    ace.submit_app("alice", infra, _topo(a=c("a", 0.1), b=c("b", 0.1)))
    ace.deploy_app("alice", "app")
    new = _topo(a=c("a", 0.1), b=c("b", 0.5), d=c("d", 0.1))
    plan = ace.update_app("alice", "app", new, incremental=True)
    assert set(plan.instances) == {"a", "b", "d"}
    assert len(ace.instances(infra, "a")) == 1
    assert len(ace.instances(infra, "d")) == 1


def test_node_shielding_redirects_placement():
    ace, infra = _platform()
    ctl = ace._controllers[str(infra.infra_id)]
    first_ec = infra.ecs[0]
    for key, node in infra.nodes.items():
        if node.cluster == first_ec:
            ctl.shield_node(infra, key)
    topo = _topo(w=Component(name="w", image=NULL, placement="edge"))
    ace.submit_app("alice", infra, topo)
    plan = ace.deploy_app("alice", "app")
    assert str(first_ec) not in plan.instances["w"][0].node


def test_topology_yaml_roundtrip():
    """The round trip through PyYAML (imported only by ``from_yaml``;
    ``to_yaml`` writes PyYAML's text itself), and the same text as
    ``repro``'s topology writes."""
    topo = _topo(a=Component(name="a", image=NULL, connections=[],
                             params={"x": 1}),
                 b=Component(name="b", image=NULL, placement="cloud",
                             replicas="per_label", labels=["camera"],
                             connections=["a"],
                             resources=Resources(cpu=0.5, memory_mb=32,
                                                 accelerator=True)))
    text = topo.to_yaml()
    again = Topology.from_yaml(text)
    assert again.to_dict() == topo.to_dict()
    assert jtopo.Topology.from_yaml(text).to_yaml() == text


@pytest.mark.parametrize("data", [
    {"app": "a", "n": [[1, 2], [3], {"k": [1]}], "e": [{}], "m": {}},
    {"s": "hello world", "t": "yes", "u": "Off", "q": "", "x": None,
     "b": [True, False], "f": [0.1, 1.0, 1e-05, 2.5e20, -3, float("inf")],
     "d": {"a": {"b": [], "c": [{"p": "x/y", "r": 1}]}}},
])
def test_to_yaml_writes_pyyamls_text(data):
    """The port's writer against ``yaml.safe_dump(..., sort_keys=False)``
    on nested blocks, scalars and the strings YAML would read as other
    types."""
    import yaml

    from repro_torch.core.topology import _block
    assert "\n".join(_block(data, "")) + "\n" == yaml.safe_dump(
        data, sort_keys=False)


def test_topology_validates_connections():
    with pytest.raises(ValueError):
        _topo(a=Component(name="a", image="i", connections=["ghost"]))


@settings(max_examples=15, deadline=None)
@given(n_comps=st.integers(1, 6), cpus=st.lists(
    st.floats(0.1, 2.0), min_size=1, max_size=6), seed=st.integers(0, 99))
def test_orchestrator_never_overcommits(n_comps, cpus, seed):
    """Property: any successful plan keeps every node within capacity."""
    ace, infra = _platform()
    comps = {}
    for i in range(n_comps):
        cpu = cpus[i % len(cpus)]
        comps[f"c{i}"] = Component(
            name=f"c{i}", image=NULL, placement="any",
            resources=Resources(cpu=cpu, memory_mb=64))
    ace.submit_app("alice", infra, Topology(app="app", version=1,
                                            components=comps))
    try:
        ace.deploy_app("alice", "app")
    except PlanningError:
        return
    for node in infra.nodes.values():
        assert node.allocated.cpu <= node.capacity.cpu + 1e-9
        assert node.allocated.memory_mb <= node.capacity.memory_mb


_COMP = st.fixed_dictionaries({
    "placement": st.sampled_from(["edge", "cloud", "any"]),
    "replicas": st.sampled_from(["one", "per_ec", "per_label"]),
    "labels": st.sampled_from([[], ["camera"], ["x86"]]),
    "cpu": st.floats(0.1, 6.0), "memory_mb": st.integers(16, 4096),
    "accelerator": st.booleans()})


@settings(max_examples=40, deadline=None)
@given(comps=st.lists(_COMP, min_size=1, max_size=6),
       num_ecs=st.integers(1, 3), nodes_per_ec=st.integers(1, 4))
def test_orchestrator_plans_equal_repro(comps, num_ecs, nodes_per_ec):
    """The same topology on the same infrastructure binds every instance
    to the same node in both packages, or fails in both."""
    labels = [["x86"], ["camera"], ["camera"], []][:nodes_per_ec]
    from repro_torch.core import topology as ttopo

    plans = []
    for plat, t in ((JaxPlatform, jtopo), (AcePlatform, ttopo)):
        ace = plat()
        ace.register_user("u")
        infra = ace.register_infrastructure(
            "u", num_ecs=num_ecs, nodes_per_ec=nodes_per_ec,
            edge_labels=labels)
        topo = t.Topology(app="app", version=1, components={
            f"c{i}": t.Component(
                name=f"c{i}", image="i", placement=c["placement"],
                replicas=c["replicas"], labels=c["labels"],
                resources=t.Resources(cpu=c["cpu"], memory_mb=c["memory_mb"],
                                      accelerator=c["accelerator"]))
            for i, c in enumerate(comps)})
        try:
            plans.append(ace.orchestrator.plan(topo, infra).to_dict())
        except Exception as e:               # PlanningError of its package
            plans.append(("error", type(e).__name__, str(e)))
    assert plans[0] == plans[1]


# -- resource-level services (paper §4.3.2, Fig. 2) ---------------------------

def _clusters():
    ids = IdAllocator()
    infra = ids.new_infra()
    cc = ids.new_cluster(infra, "cc")
    ec1 = ids.new_cluster(infra, "ec")
    ec2 = ids.new_cluster(infra, "ec")
    return cc, ec1, ec2


def test_local_delivery_and_bridging():
    cc, ec1, ec2 = _clusters()
    msg = MessageService([cc, ec1, ec2], SimClock(), network=None)
    got = {"cc": [], "ec1": [], "ec2": []}
    msg.broker(cc).subscribe("app/*", lambda m: got["cc"].append(m.topic))
    msg.broker(ec1).subscribe("app/*", lambda m: got["ec1"].append(m.topic))
    msg.broker(ec2).subscribe("app/*", lambda m: got["ec2"].append(m.topic))
    msg.broker(ec1).publish("app/result", {"v": 1}, src="comp-a")
    assert got == {"cc": ["app/result"], "ec1": ["app/result"],
                   "ec2": ["app/result"]}


def test_bridge_no_loops():
    cc, ec1, _ = _clusters()
    msg = MessageService([cc, ec1], SimClock(), network=None)
    count = {"n": 0}
    msg.broker(cc).subscribe("t/*", lambda m: count.__setitem__(
        "n", count["n"] + 1))
    msg.broker(ec1).publish("t/x", 1, src="a")
    assert count["n"] == 1


def test_wan_timing_on_bridge():
    cc, ec1, _ = _clusters()
    clock = SimClock()
    net = NetworkModel(clock, uplink_mbps=8.0, wan_delay_s=0.05)
    msg = MessageService([cc, ec1], clock, network=net)
    seen = []
    msg.broker(cc).subscribe("big/*", lambda m: seen.append(clock.now))
    msg.broker(ec1).publish("big/blob", b"", nbytes=1_000_000, src="a")
    assert not seen
    clock.run()
    assert seen and abs(seen[0] - 1.05) < 1e-6  # 1 MB / 8 Mbps + 50 ms


def test_link_serialization_creates_backlog():
    cc, ec1, _ = _clusters()
    clock = SimClock()
    net = NetworkModel(clock, uplink_mbps=8.0)
    arrivals = []
    for _ in range(3):
        net.send(ec1, cc, 1_000_000, lambda: arrivals.append(clock.now))
    clock.run()
    assert [round(a, 3) for a in arrivals] == [1.0, 2.0, 3.0]
    assert net.wan_bytes() == 3_000_000


def test_file_service_control_data_separation():
    cc, ec1, ec2 = _clusters()
    clock = SimClock()
    net = NetworkModel(clock, uplink_mbps=80.0, downlink_mbps=80.0,
                       wan_delay_s=0.01)
    msg = MessageService([cc, ec1, ec2], clock, network=net)
    store = ObjectStore()
    files = FileService(msg, store, net, clock, cc)
    control_msgs, fetched = [], []
    files.on_available(ec2, "models/*", control_msgs.append)
    files.put("models", "eoc-v1", {"weights": [1, 2, 3]}, nbytes=500_000,
              src_cluster=ec1)
    clock.run()
    assert control_msgs and control_msgs[0]["key"] == "eoc-v1"
    assert store.get("models", "eoc-v1") is not None
    files.get("models", "eoc-v1", ec2, fetched.append)
    clock.run()
    assert fetched == [{"weights": [1, 2, 3]}]


def test_object_store_lifecycle():
    store = ObjectStore()
    store.put("b", "temp1", 1, 10, lifecycle="temporary")
    store.put("b", "final", 2, 10, lifecycle="permanent")
    assert store.gc_temporary("b") == 1
    assert store.keys("b") == ["final"]


def test_missing_object_raises():
    cc, ec1, _ = _clusters()
    msg = MessageService([cc, ec1], SimClock(), network=None)
    files = FileService(msg, ObjectStore(), None, SimClock(), cc)
    with pytest.raises(KeyError):
        files.get("b", "nope", ec1, lambda d: None)


# -- the ECC patterns -----------------------------------------------------------

def test_fedavg_math():
    from repro_torch.core.patterns.training import fedavg
    a = {"w": torch.tensor([0.0, 2.0])}
    b = {"w": torch.tensor([4.0, 0.0])}
    avg = fedavg([a, b], weights=[1.0, 3.0])
    assert avg["w"].dtype == torch.float32
    assert np.allclose(avg["w"].numpy(), [3.0, 0.5])


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_fedavg_matches_repro(kind):
    """Nested dicts and lists, f32 and bf16 leaves, float64 weights: the
    same average and dtypes as ``repro``'s (without x64, f32 stays f32)."""
    import jax
    import jax.numpy as jnp
    from repro.core.patterns.training import fedavg as jax_fedavg
    from repro_torch.core.patterns.training import fedavg

    rng = np.random.default_rng(0)
    sets = [{"w": rng.normal(size=(3, 4)).astype(np.float32),
             "stages": [{"b": rng.normal(size=5).astype(np.float32)}]}
            for _ in range(3)]
    weights = [512.0, 100.0, 7.0]
    theirs = jax_fedavg([jax.tree.map(jnp.asarray, s) for s in sets],
                        weights)
    if kind == "tensor":
        ours = fedavg([{"w": torch.from_numpy(s["w"]),
                        "stages": [{"b": torch.from_numpy(s["stages"][0]["b"])
                                    .to(torch.bfloat16)}]} for s in sets],
                      weights)
        assert ours["stages"][0]["b"].dtype == torch.bfloat16
        np.testing.assert_array_equal(ours["w"].numpy(),
                                      np.asarray(theirs["w"]))
    else:
        ours = fedavg(sets, weights)
        assert ours["w"].dtype == np.float32
        np.testing.assert_array_equal(ours["w"], np.asarray(theirs["w"]))
        np.testing.assert_array_equal(ours["stages"][0]["b"],
                                      np.asarray(theirs["stages"][0]["b"]))


def test_ecc_processing_pipeline():
    """ECC processing pattern: an edge->cloud pipeline over bridged topics."""
    from repro_torch.core.patterns.processing import pipeline_topology

    ace = AcePlatform()
    ace.register_user("u")
    infra = ace.register_infrastructure("u", num_ecs=1, nodes_per_ec=2)
    ace.deploy_services(infra)
    stages = [
        {"name": "filter", "placement": "edge",
         "fn": lambda x: x if x % 2 == 0 else None},
        {"name": "square", "placement": "edge", "fn": lambda x: x * x},
        {"name": "store", "placement": "cloud", "fn": lambda x: x},
    ]
    ace.submit_app("u", infra, pipeline_topology("pipe", stages))
    ace.deploy_app("u", "pipe")
    broker = ace.message_service(infra).broker(infra.ecs[0])
    for i in range(6):
        broker.publish("pipe/in", i, src="feeder")
    store = ace.instances(infra, "store")[0][1]
    assert sorted(store.outputs) == [0, 4, 16]


def test_hybrid_pattern_teacher_student():
    ace = AcePlatform()
    ace.register_user("u")
    infra = ace.register_infrastructure("u", num_ecs=1, nodes_per_ec=2)
    ace.deploy_services(infra)
    topo = Topology(app="hy", version=1, components={
        "teacher": Component(name="teacher", image="repro/pattern/teacher",
                             placement="cloud", params={"init": {
                                 "teacher_infer": lambda item: item * 10,
                                 "train_student": lambda p, buf: {"bias": 1},
                                 "student_params": {"bias": 0},
                                 "refresh_every": 2}}),
        "student": Component(name="student", image="repro/pattern/student",
                             placement="edge", params={"init": {
                                 "student_infer": lambda p, item: (
                                     item * 10, 0.9 if item < 5 else 0.1)}}),
    })
    ace.submit_app("u", infra, topo)
    ace.deploy_app("u", "hy")
    ec_broker = ace.message_service(infra).broker(infra.ecs[0])
    for i in range(8):
        ec_broker.publish("hybrid/in", i, src="feeder")
    student = ace.instances(infra, "student")[0][1]
    teacher = ace.instances(infra, "teacher")[0][1]
    assert len(student.results) > 0          # confident items kept at edge
    assert student.escalated > 0             # hard items escalated
    assert teacher.version >= 1              # online student refresh


def test_federated_pattern_on_the_platform():
    """FedWorker on each EC and FedAvgAggregator on the CC: two rounds of
    local steps over the file service, averaged by sample counts."""
    def local_train(params, data):
        x, y = data
        w = params["w"].clone()
        for _ in range(5):
            w = w - 0.1 * 2 * x.T @ (x @ w - y) / len(x)
        return {"w": w}, float(torch.mean((x @ w - y) ** 2))

    rng = np.random.default_rng(0)
    w_true = torch.tensor([1.0, -2.0])
    data = []
    for n in (32, 96):
        x = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))
        data.append((x, x @ w_true))
    ace = AcePlatform()
    ace.register_user("u")
    infra = ace.register_infrastructure("u", num_ecs=2, nodes_per_ec=1)
    ace.deploy_services(infra)
    # workers first: they subscribe before the aggregator broadcasts
    comps = {f"w{i}": Component(
        name=f"w{i}", image="repro/pattern/fed-worker", placement="edge",
        params={"init": {"local_train": local_train, "data": d,
                         "rounds": 2}}) for i, d in enumerate(data)}
    comps["agg"] = Component(
        name="agg", image="repro/pattern/fed-aggregator", placement="cloud",
        params={"init": {"init_params": {"w": torch.zeros(2)},
                         "num_workers": 2, "rounds": 2}})
    ace.submit_app("u", infra, Topology(app="fed", version=1,
                                        components=comps))
    ace.deploy_app("u", "fed")
    agg = ace.instances(infra, "agg")[0][1]
    workers = [ace.instances(infra, f"w{i}")[0][1] for i in range(2)]
    assert agg.round_idx == 2
    assert all(len(w.history) == 2 for w in workers)
    assert all(w.history[1] < w.history[0] for w in workers)
    assert float(torch.sum((agg.global_params["w"] - w_true) ** 2)) < \
        float(torch.sum(w_true ** 2))
