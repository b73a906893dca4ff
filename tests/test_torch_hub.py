"""The port's Hub client (hub.py) and its CLI's ``download`` and ``models``
against the JAX package's, with no network: ``huggingface_hub`` is made
absent (so both take the plain-HTTP path) and one fake
``urllib.request.urlopen`` serves both packages, recording every request.

Compared: the URLs, headers (``HF_TOKEN``'s Authorization), timeouts,
target paths, file bytes, printed progress and lines, and the errors (their
type and text); a file already in the cache is returned without a
request."""

import io
import os
import sys
import urllib.error
import urllib.request

import pytest

from llama_gguf_tpu import cli as jcli
from llama_gguf_tpu import hub as jhub

from llama_gguf_tpu_torch import cli, hub

SIBLINGS = {"siblings": [{"rfilename": n} for n in (
    "model-Q8_0.gguf", "README.md", "model-Q4_K_M.gguf", "sub/x.gguf")]}
ONE = {"siblings": [{"rfilename": "only.gguf"}, {"rfilename": "a.txt"}]}
PAYLOAD = bytes(range(256)) * 9000  # 2.3 MB: three reads of 1 MiB


class FakeResponse(io.BytesIO):
    def __init__(self, data: bytes, length: bool = True):
        super().__init__(data)
        self.headers = {"Content-Length": str(len(data))} if length else {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@pytest.fixture
def net(monkeypatch):
    """The fake network: (calls, routes). ``calls`` gets (url, headers,
    timeout) per request; ``routes`` maps a URL to its answer (bytes, or an
    exception to raise)."""
    import json

    calls = []
    routes = {
        "https://huggingface.co/api/models/org/repo": json.dumps(
            SIBLINGS).encode(),
        "https://huggingface.co/api/models/org/one": json.dumps(
            ONE).encode(),
    }

    def urlopen(req, timeout=None):
        calls.append((req.full_url, dict(req.header_items()), timeout))
        answer = routes.get(req.full_url)
        if answer is None:
            raise urllib.error.URLError("no route to host")
        if isinstance(answer, Exception):
            raise answer
        return FakeResponse(answer)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    monkeypatch.delenv("HF_TOKEN", raising=False)
    monkeypatch.delenv("LLAMA_GGUF_CACHE_DIR", raising=False)
    return calls, routes


def both(fn):
    """fn(module) for the port's hub, then the JAX package's."""
    return fn(hub), fn(jhub)


@pytest.mark.parametrize("token", [None, "hf_secret"])
@pytest.mark.parametrize("repo", ["org/repo", "org/one"])
def test_list_gguf_files_matches_jax(net, monkeypatch, tmp_path, token,
                                     repo):
    calls, _ = net
    if token:
        monkeypatch.setenv("HF_TOKEN", token)
    got, want = both(lambda m: m.HubClient(str(tmp_path)).list_gguf_files(
        repo))
    assert got == want and got
    assert calls[0] == calls[1]
    assert calls[0][0] == f"https://huggingface.co/api/models/{repo}"
    assert calls[0][2] == 30
    assert calls[0][1] == ({"Authorization": f"Bearer {token}"} if token
                           else {})


@pytest.mark.parametrize("progress", [True, False])
def test_download_matches_jax(net, tmp_path, capsys, progress):
    calls, routes = net
    url = "https://huggingface.co/org/repo/resolve/main/sub/model.gguf"
    routes[url] = PAYLOAD
    paths = []
    outs = []
    for m in (hub, jhub):
        client = m.HubClient(str(tmp_path / m.__name__), token="tok")
        paths.append(client.download("org/repo", "sub/model.gguf",
                                     progress=progress))
        outs.append(capsys.readouterr().out)
        # cached: the second call makes no request
        n = len(calls)
        assert client.download("org/repo", "sub/model.gguf") == paths[-1]
        assert len(calls) == n
    assert [os.path.relpath(p, tmp_path / m.__name__)
            for p, m in zip(paths, (hub, jhub))] == \
        ["org--repo/model.gguf"] * 2
    for p in paths:
        assert open(p, "rb").read() == PAYLOAD
    assert outs[0] == outs[1]
    assert ("100.0%" in outs[0]) == progress
    assert calls[0] == calls[1] == (url, {"Authorization": "Bearer tok"}, 60)


@pytest.mark.parametrize("error", [
    urllib.error.URLError("no route to host"),
    urllib.error.HTTPError("u", 404, "Not Found", {}, None),
    TimeoutError("timed out")], ids=["url", "http404", "timeout"])
def test_errors_match_jax(net, tmp_path, error):
    _, routes = net
    routes["https://huggingface.co/api/models/org/bad"] = error
    routes["https://huggingface.co/org/bad/resolve/main/f.gguf"] = error
    for call in (lambda c: c.list_gguf_files("org/bad"),
                 lambda c: c.download("org/bad", "f.gguf"),
                 lambda c: c.search("llama")):
        msgs = []
        for m in (hub, jhub):
            client = m.HubClient(str(tmp_path / m.__name__))
            with pytest.raises(m.HubError) as e:
                call(client)
            msgs.append(str(e.value))
            # a failed download leaves no partial file behind
            assert not list((tmp_path / m.__name__).rglob("*.part"))
        assert msgs[0] == msgs[1]


def test_cache_dir_and_local_listing_match_jax(net, monkeypatch, tmp_path):
    calls, _ = net
    monkeypatch.setenv("LLAMA_GGUF_CACHE_DIR", str(tmp_path / "env"))
    got, want = both(lambda m: str(m.HubClient().cache_dir))
    assert got == want == str(tmp_path / "env")
    monkeypatch.delenv("LLAMA_GGUF_CACHE_DIR")
    got, want = both(lambda m: str(m.HubClient().cache_dir))
    assert got == want == os.path.expanduser(hub.DEFAULT_CACHE_DIR)
    d = tmp_path / "c" / "org--repo"
    d.mkdir(parents=True)
    for name in ("a.gguf", "b.gguf", "c.txt"):
        (d / name).write_bytes(b"x" * (10 + len(name)))
    os.utime(d / "a.gguf", (1, 1))
    got, want = both(lambda m: m.HubClient(str(tmp_path / "c"))
                     .list_local_models())
    assert got == want
    assert [os.path.basename(p) for p, _ in got] == ["b.gguf", "a.gguf"]
    client = hub.HubClient(str(tmp_path / "c"))
    client.evict(str(tmp_path / "elsewhere.gguf"))  # outside: left alone
    client.evict(str(d / "a.gguf"))
    assert [os.path.basename(p) for p, _ in client.list_local_models()] == \
        ["b.gguf"]
    assert not calls


@pytest.mark.parametrize("argv", [
    ["org/repo", "--list"],
    ["org/repo"],  # several files: the list only
    ["org/one"],  # one file: listed, then downloaded
    ["org/one", "only.gguf"],
    ["org/one", "only.gguf", "--list"],
], ids=["list", "several", "one", "named", "named-list"])
def test_download_cli_matches_jax(net, tmp_path, capsys, argv):
    calls, routes = net
    routes["https://huggingface.co/org/one/resolve/main/only.gguf"] = \
        b"GGUF" * 10
    outs = []
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        d = str(tmp_path / name)
        assert main(["download"] + argv + ["--dir", d]) == 0
        outs.append(capsys.readouterr().out.replace(d, "DIR"))
        outs.append(main(["models", "--dir", d]))
        outs.append(capsys.readouterr().out.replace(d, "DIR"))
    assert outs[:3] == outs[3:]
    assert calls[:len(calls) // 2] == calls[len(calls) // 2:]


def test_download_cli_cached_makes_no_request(net, tmp_path, capsys):
    """A file already in the cache: its path, and no request."""
    calls, _ = net
    d = tmp_path / "cache" / "org--repo"
    d.mkdir(parents=True)
    (d / "model.gguf").write_bytes(b"GGUF")
    for main in (cli.main, jcli.main):
        assert main(["download", "org/repo", "model.gguf", "--dir",
                     str(tmp_path / "cache")]) == 0
        assert capsys.readouterr().out == f"{d / 'model.gguf'}\n"
    assert not calls


def test_download_cli_error_matches_jax(net, tmp_path):
    errors = []
    for main, m in ((cli.main, hub), (jcli.main, jhub)):
        with pytest.raises(m.HubError) as e:
            main(["download", "org/missing", "--dir", str(tmp_path)])
        errors.append(str(e.value))
    assert errors[0] == errors[1] == \
        "cannot reach HuggingFace Hub: <urlopen error no route to host>"
