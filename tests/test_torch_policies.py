"""The registry names that tests/test_torch_extender.py leaves out, each
driven through ``tests/torch_parity.Twin``: the JAX package's server and
the port's (``device="cpu"``) must give equal ExtenderFilterResults,
reservations, demands and soft reservations.  Every scenario of that
file runs under each name (its random sequence with one seed): the host
policies (distribute-evenly, minimal-fragmentation), the single-AZ
family on the host (az-aware-tightly-pack, single-az-tightly-pack,
single-az-minimal-fragmentation) and two more tensor-solver names
(tpu-batch-az-aware, tpu-batch-single-az-minimal-fragmentation)."""

import pytest

import test_torch_extender as extender_cases
from torch_parity import Twin

NAMES = (
    "distribute-evenly",
    "minimal-fragmentation",
    "az-aware-tightly-pack",
    "single-az-tightly-pack",
    "single-az-minimal-fragmentation",
    "tpu-batch-az-aware",
    "tpu-batch-single-az-minimal-fragmentation",
)

SCENARIOS = sorted(n for n in dir(extender_cases) if n.startswith("test_"))


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s[5:] for s in SCENARIOS])
@pytest.mark.parametrize("name", NAMES)
def test_registry_name_matches_the_reference(name, scenario):
    made = []

    def factory(*args, **kw):
        twin = Twin(*args, **kw)
        made.append(twin)
        return twin

    try:
        args = (factory, name) + ((0,) if scenario == "test_random_filter_sequence" else ())
        getattr(extender_cases, scenario)(*args)
        assert made and all(twin.results for twin in made)
    finally:
        for twin in made:
            twin.close()
