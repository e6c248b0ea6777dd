"""The port's HTTP front end (vaq_tpu_torch/serving_http.py), case for case
with tests/test_serving_http.py, on the CPU: the same JSON shapes, error
codes, concurrent-client batching and stats, over a port index converted
from a JAX index; the answers equal the port's ``search`` and JAX's HTTP
server's over the JAX index.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import vaq_tpu
from test_torch_vaq import jax_state
from vaq_tpu.serving import SearchServer as JaxServer
from vaq_tpu.serving_http import SearchHTTPServer as JaxHTTP
from vaq_tpu_torch.convert import index_from_numpy
from vaq_tpu_torch.serving import SearchServer
from vaq_tpu_torch.serving_http import SearchHTTPServer

torch.set_num_threads(2)  # six test workers share the host


def _serve(server_cls, http_cls, idx):
    srv = server_cls(idx, k=10, max_batch=32, max_wait_ms=2.0)
    http = http_cls(srv, host="127.0.0.1", port=0).start()
    host, port = http.address[:2]
    return srv, http, f"http://{host}:{port}"


@pytest.fixture(scope="module")
def http_setup(sift_like):
    """(port index, queries, port root URL, JAX root URL)."""
    base, queries, _ = sift_like
    cfg = vaq_tpu.parse_method_string("VAQ128m16min7max8var1,SORT")
    jidx = vaq_tpu.VAQIndex(cfg).train(base).encode(base)
    idx = index_from_numpy(*jax_state(jidx), "cpu")
    srv, http, root = _serve(SearchServer, SearchHTTPServer, idx)
    jsrv, jhttp, jroot = _serve(JaxServer, JaxHTTP, jidx)
    yield idx, queries, root, jroot
    for h, s in ((http, srv), (jhttp, jsrv)):
        h.close()
        s.close()


def _post(url, obj, timeout=60.0):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def test_healthz_and_404(http_setup):
    _, _, root, _ = http_setup
    assert _get(root + "/healthz") == {"ok": True}
    for path in ("/nope", "/search"):        # GET /search is no route
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(root + path)
        assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(root + "/stats", {})
    assert ei.value.code == 404


def test_search_roundtrip_matches_index(http_setup):
    idx, queries, root, jroot = http_setup
    out = _post(root + "/search", {"query": queries[0].tolist()})
    labels = np.asarray(out["labels"])
    dists = np.asarray(out["distances"])
    assert labels.shape == (1, 10) and dists.shape == (1, 10)
    _, ref_i = idx.search(queries[:1], 10)
    np.testing.assert_array_equal(labels, np.asarray(ref_i))
    jout = _post(jroot + "/search", {"query": queries[0].tolist()})
    np.testing.assert_array_equal(labels, np.asarray(jout["labels"]))
    np.testing.assert_allclose(dists, np.asarray(jout["distances"]),
                               rtol=1e-5)


def test_search_group_and_small_k(http_setup):
    idx, queries, root, _ = http_setup
    out = _post(root + "/search",
                {"query": queries[:3].tolist(), "k": 5})
    assert np.asarray(out["labels"]).shape == (3, 5)
    np.testing.assert_array_equal(np.asarray(out["labels"]),
                                  idx.search(queries[:3], 10)[1][:, :5])


def test_bad_requests(http_setup):
    _, queries, root, jroot = http_setup
    for body, code in [
        ({"query": queries[0].tolist(), "k": 99}, 400),   # k > server k
        ({"nope": 1}, 400),                                # missing query
        ({"query": [[[1.0]]]}, 400),                       # 3-d query
    ]:
        for r in (root, jroot):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(r + "/search", body)
            assert ei.value.code == code


def test_body_cap(http_setup):
    """A body over max_body (or none) is refused with 413, as JAX's."""
    idx, queries, _, _ = http_setup
    srv = SearchServer(idx, k=10, max_batch=4)
    http = SearchHTTPServer(srv, port=0, max_body=64).start()
    host, port = http.address[:2]
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"http://{host}:{port}/search",
                  {"query": queries[0].tolist()})
        assert ei.value.code == 413
    finally:
        http.close()
        srv.close()


def test_concurrent_http_clients(http_setup):
    idx, queries, root, _ = http_setup
    n = 24
    results = [None] * n
    errs = []

    def worker(j):
        try:
            results[j] = _post(root + "/search",
                               {"query": queries[j].tolist()})
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(j,)) for j in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    labels = np.concatenate([np.asarray(r["labels"]) for r in results])
    _, ref_i = idx.search(queries[:n], 10)
    np.testing.assert_array_equal(labels, np.asarray(ref_i))
    stats = _get(root + "/stats")
    assert stats["queries_served"] >= n
    assert stats["batches_served"] >= 1
    assert "p50_ms" in stats
