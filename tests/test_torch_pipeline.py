"""The port's token pipeline and record store against the JAX package, on
the CPU: ``TokenPipeline.batch_at`` array for array over steps and host
shards, and ``RecordStore`` (lookups, dedup, inserts, a shared service with
a tenant, the both-given error) answering as the reference's on the same
corpus.  Every service is closed by the ``stores`` fixture."""
import numpy as np
import pytest
import torch

from repro.data import pipeline as r_pipe
from repro_torch.data import pipeline as t_pipe
from repro_torch.index import IndexConfig
from repro_torch.serve import IndexService


@pytest.mark.parametrize("host_id,n_hosts", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_batch_at_equals_reference(host_id, n_hosts):
    kw = dict(vocab=97, seq_len=12, global_batch=8, seed=4, host_id=host_id, n_hosts=n_hosts)
    ref = r_pipe.TokenPipeline(r_pipe.PipelineConfig(**kw))
    port = t_pipe.TokenPipeline(t_pipe.PipelineConfig(**kw))
    for step in (0, 1, 5, 11, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert sorted(want) == sorted(got) == ["labels", "tokens"]
        for k in want:
            assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k])
    for (a, b), _ in zip(zip(ref, port), range(3)):
        assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.fixture
def stores():
    """Stores and services a test makes, closed after it whatever its outcome."""
    made = []
    yield made
    for s in made:
        s.close()


def _cpu():
    return IndexConfig(device="cpu")


def test_record_store_answers_as_reference(stores):
    docs = [b"doc:%05d" % i for i in range(400)]
    payloads = np.arange(400, dtype=np.int64) * 3 + 7
    ref = r_pipe.RecordStore(docs, payloads)
    stores.append(ref)
    port = t_pipe.RecordStore(docs, payloads, config=_cpu())
    stores.append(port)
    probe = docs[::7] + [b"doc:9%04d" % i for i in range(20)] + [b"", docs[3] + b"x"]
    for a, b in zip(ref.lookup_batch(probe), port.lookup_batch(probe)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ref.dedup(probe), port.dedup(probe))
    for key, payload in ((docs[10], 1), (b"doc:new-1", 11), (b"doc:new-1", 12), (b"doc:new-2", 13)):
        assert ref.insert(key, payload) == port.insert(key, payload)
    probe += [b"doc:new-1", b"doc:new-2"]
    for a, b in zip(ref.lookup_batch(probe), port.lookup_batch(probe)):
        np.testing.assert_array_equal(a, b)


def test_record_store_on_a_shared_service(stores):
    docs = [b"rec-%04d" % i for i in range(300)]
    vals = np.arange(300, dtype=np.int64)
    svc = IndexService.bulk_load({"ds": (docs, vals), "other": (docs[:50], vals[:50] + 1000)},
                                 _cpu())
    stores.append(svc)
    store = t_pipe.RecordStore([], service=svc, tenant="ds")
    stores.append(store)
    found, got = store.lookup_batch(docs[::9] + [b"nope"])
    assert found[:-1].all() and not found[-1]
    np.testing.assert_array_equal(got[:-1], vals[::9])
    assert store.insert(b"rec-new", 5) and not store.insert(docs[0], 6)
    assert store.lookup_batch([b"rec-new"])[1][0] == 5
    # the other tenant sees neither the insert nor the store's keys past its own
    other = t_pipe.RecordStore([], service=svc, tenant="other")
    assert not other.lookup_batch([b"rec-new", docs[60]])[0].any()
    store.close()  # the store did not make the service: it keeps running
    assert store.lookup_batch([docs[1]])[0][0]
    with pytest.raises(ValueError, match="not both"):
        t_pipe.RecordStore(docs, service=svc, tenant="ds")
    with pytest.raises(ValueError, match="not both"):
        r_pipe.RecordStore(docs, service=object(), tenant="ds")


def test_record_store_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        t_pipe.RecordStore([b"a", b"b"])
