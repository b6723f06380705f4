"""The port's informer (kube/informer.py) against the JAX package's: the
same event stream gives the same store and revision, out-of-order
deliveries are dropped, and the tombstone map of departed objects stays
bounded.  The port prunes that map when the departed objects' entries
pass ``_TOMBSTONE_LIMIT``, where the reference prunes when all entries
do: with more live objects than the limit (a cluster of 20,000 nodes)
the reference rebuilds the map on every event, the port never."""

import pytest

from k8s_spark_scheduler_tpu.kube.apiserver import APIServer as JaxAPIServer
from k8s_spark_scheduler_tpu.kube.informer import Informer as JaxInformer
from k8s_spark_scheduler_tpu.types.objects import ObjectMeta as JaxObjectMeta
from k8s_spark_scheduler_tpu.types.objects import Pod as JaxPod
from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
from k8s_spark_scheduler_tpu_torch.kube.informer import MODIFIED, Informer
from k8s_spark_scheduler_tpu_torch.types.objects import ObjectMeta, Pod

LIMIT = 4


@pytest.fixture
def small_limit(monkeypatch):
    monkeypatch.setattr(Informer, "_TOMBSTONE_LIMIT", LIMIT)
    monkeypatch.setattr(JaxInformer, "_TOMBSTONE_LIMIT", LIMIT)


def _pair():
    api, jax_api = APIServer(), JaxAPIServer()
    inf, jax_inf = Informer(api, Pod.KIND), JaxInformer(jax_api, JaxPod.KIND)
    inf.start()
    jax_inf.start()
    return api, jax_api, inf, jax_inf


def _names(informer) -> list:
    return sorted(p.name for p in informer.list())


def test_a_store_past_the_limit_is_not_rebuilt_on_every_event(small_limit):
    api, jax_api, inf, jax_inf = _pair()
    maps = set()
    for i in range(3 * LIMIT):
        api.create(Pod(meta=ObjectMeta(name=f"p{i}")))
        jax_api.create(JaxPod(meta=JaxObjectMeta(name=f"p{i}")))
        maps.add(id(inf._last_rv))
    # no object departed: the map of last-seen versions is the one built
    # at the start, never rebuilt (the reference rebuilds it from the
    # (LIMIT + 1)-th object on)
    assert len(maps) == 1
    assert len(inf._last_rv) == 3 * LIMIT
    assert _names(inf) == _names(jax_inf) and inf.revision == jax_inf.revision


def test_departed_objects_are_pruned_past_the_limit(small_limit):
    api, jax_api, inf, jax_inf = _pair()
    for i in range(3 * LIMIT):
        api.create(Pod(meta=ObjectMeta(name=f"p{i}")))
        jax_api.create(JaxPod(meta=JaxObjectMeta(name=f"p{i}")))
    gone = LIMIT + 2
    for i in range(gone):
        api.delete(Pod.KIND, "default", f"p{i}")
        jax_api.delete(JaxPod.KIND, "default", f"p{i}")
    # the last deletion found LIMIT + 1 departed entries (before its own):
    # pruned to the objects then mirrored, so only its own entry departs
    assert set(inf._last_rv) == {("default", f"p{i}") for i in range(gone - 1, 3 * LIMIT)}
    assert _names(inf) == _names(jax_inf) and inf.revision == jax_inf.revision


def test_a_stale_event_of_a_departed_object_is_dropped(small_limit):
    api, _, inf, _ = _pair()
    for i in range(2 * LIMIT):
        api.create(Pod(meta=ObjectMeta(name=f"p{i}")))
    stale = inf.get("default", "p0").deepcopy()
    api.delete(Pod.KIND, "default", "p0")
    revision = inf.revision
    # a late MODIFIED carrying the deleted object's old version: its
    # tombstone is still held (one departed entry, under the limit)
    inf._on_event(MODIFIED, stale)
    assert inf.get("default", "p0") is None and inf.revision == revision
