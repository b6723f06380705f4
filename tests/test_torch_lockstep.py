"""Two harnesses of ONE package driven in lockstep: the check behind the
Twin's settling (``tests/torch_parity.Twin.settle``).

Both packages write reservations and demands back on worker threads.
Settled before every Filter and delete, two harnesses of the same package
decide identically on the random Filter sequence of
tests/test_torch_extender.py (the tests below, for the JAX package and
the port).  Unsettled and under load they need not: run this file as a
script beside other load to count the divergences of each package,

    JAX_PLATFORMS=cpu python tests/test_torch_lockstep.py --unsettled --reps 3

(8 such processes at once gave divergences in both packages), which is
why the Twin compares only decisions made on settled state."""

import argparse
import os
import random
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_parity as tp  # noqa: E402
from k8s_spark_scheduler_tpu import timesource as jax_timesource  # noqa: E402
from k8s_spark_scheduler_tpu.config import FifoConfig as JaxFifoConfig  # noqa: E402
from k8s_spark_scheduler_tpu.config import Install as JaxInstall  # noqa: E402
from k8s_spark_scheduler_tpu.config import ProvenanceConfig as JaxProvenanceConfig  # noqa: E402
from k8s_spark_scheduler_tpu.testing.harness import Harness as JaxHarness  # noqa: E402
from k8s_spark_scheduler_tpu.types import serde as jax_serde  # noqa: E402
from k8s_spark_scheduler_tpu_torch import timesource as port_timesource  # noqa: E402
from k8s_spark_scheduler_tpu_torch.config import FifoConfig as PortFifoConfig  # noqa: E402
from k8s_spark_scheduler_tpu_torch.convert import object_from_wire  # noqa: E402
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness as PortHarness  # noqa: E402
from k8s_spark_scheduler_tpu_torch.types import serde as port_serde  # noqa: E402

POLICIES = ("tpu-batch", "tpu-batch-distribute-evenly", "tightly-pack")


def _harness(package: str, policy: str):
    if package == "jax":
        return JaxHarness(extra_install=JaxInstall(
            fifo=True, fifo_config=JaxFifoConfig(), binpack_algo=policy, instance_group_label=tp.IG_LABEL,
            delta_solve=False, provenance=JaxProvenanceConfig(enabled=False),
        ))
    return PortHarness(binpack_algo=policy, is_fifo=True, fifo_config=PortFifoConfig(),
                       instance_group_label=tp.IG_LABEL, device="cpu")


class SelfTwin(tp.Twin):
    """A Twin whose two sides are harnesses of the same package
    (``self.jax`` and ``self.port`` name the two sides only)."""

    def __init__(self, package: str, policy: str, settled: bool = True):
        self.now = tp.T0
        jax_timesource.set_source(lambda: self.now)
        port_timesource.set_source(lambda: self.now)
        self.settled = settled
        self.decode = tp.jax_serde_decode if package == "jax" else object_from_wire
        serde = jax_serde if package == "jax" else port_serde
        self.rr_encode, self.demand_encode = serde.rr_to_dict_v1beta2, serde.demand_to_dict_v1alpha2
        self.jax = self.port = None
        try:
            self.jax, self.port = _harness(package, policy), _harness(package, policy)
        except BaseException:
            self.close()
            raise
        self.results, self.invariant_checks = [], 0

    def settle(self) -> None:
        if self.settled:
            super().settle()

    def _create(self, wire: dict) -> None:
        for h in (self.jax, self.port):
            h.api.create(self.decode(wire))

    def schedule(self, wire: dict, node_names):
        self.settle()
        a, b = (h.schedule(self.decode(wire), node_names) for h in (self.jax, self.port))
        assert a.to_dict() == b.to_dict(), (a.to_dict(), b.to_dict())
        return b.node_names[0] if b.node_names else None

    def assert_state_equal(self) -> None:
        super().settle()
        assert self._reservations(self.port, self.rr_encode) == self._reservations(self.jax, self.rr_encode)
        assert self._demands(self.port, self.demand_encode) == self._demands(self.jax, self.demand_encode)


def random_sequence(twin, policy: str, seed: int) -> None:
    """tests/test_torch_extender.py's random Filter sequence."""
    rng = random.Random(1000 * seed + len(policy))
    nodes = []
    for i in range(rng.randint(4, 8)):
        twin.add_node(f"n{i}", cpu=str(rng.randint(4, 16)), memory=f"{rng.randint(4, 32)}Gi",
                      zone=f"zone{rng.randint(0, 2)}")
        nodes.append(f"n{i}")
    live = []
    for step in range(14):
        action = rng.random()
        if action < 0.55 or not live:
            app_id = f"app-{step}"
            if rng.random() < 0.3:
                pods = twin.dynamic_pods(app_id, 1, rng.randint(2, 3), age=rng.randint(0, 50))
            else:
                pods = twin.static_pods(
                    app_id, rng.randint(1, 4), age=rng.randint(0, 50),
                    executor_cpu=str(rng.randint(1, 3)), executor_mem=f"{rng.randint(1, 4)}Gi",
                )
            if rng.random() < 0.2:
                twin.create_pod(pods[0])
            if twin.schedule(pods[0], nodes) is not None:
                bound = [pods[0]]
                for p in pods[1:]:
                    if twin.schedule(p, nodes) is not None:
                        bound.append(p)
                live.append(bound)
        elif action < 0.75:
            app = rng.choice(live)
            if len(app) > 1:
                twin.delete_pod(app.pop(rng.randrange(1, len(app))))
        else:
            for p in live.pop(rng.randrange(len(live))):
                twin.delete_pod(p)
            twin.advance(rng.choice((1, 20)))
    twin.assert_state_equal()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("package", ("jax", "port"))
def test_settled_harnesses_of_one_package_agree(package, policy, seed):
    twin = SelfTwin(package, policy)
    try:
        random_sequence(twin, policy, seed)
    finally:
        twin.close()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--unsettled", action="store_true", help="do not settle before Filters and deletes")
    parser.add_argument("--reps", type=int, default=1)
    args = parser.parse_args()
    runs = diverged = 0
    for package in ("jax", "port"):
        for policy in POLICIES:
            for seed in range(3):
                for _ in range(args.reps):
                    twin = SelfTwin(package, policy, settled=not args.unsettled)
                    runs += 1
                    try:
                        random_sequence(twin, policy, seed)
                    except AssertionError:
                        diverged += 1
                        print(f"{package} {policy} seed {seed}: the two harnesses diverged", flush=True)
                    finally:
                        twin.close()
    print(f"{diverged} of {runs} sequences diverged")
    return 0


if __name__ == "__main__":
    sys.exit(main())
