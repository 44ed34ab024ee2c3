"""`python -m rama_tpu_torch.server.app --tp 2 --device cpu` as a user runs it:
the server process is rank 0 and spawns rank 1, /gen streams JAX's
single-process Engine(tp_size=2) greedy chain of the same checkpoint, and
SIGINT stops the server, which stops and joins its follower."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import pytest

from _torch_port import torch_cfg, write_tokenizer_bin
from rama_tpu.config import EngineConfig as JEcfg
from rama_tpu.models import llama as jl
from rama_tpu.runtime.engine import Engine as JEngine
from rama_tpu.runtime.engine import Request as JRequest
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu.tokenizer import Tokenizer as JTok
from rama_tpu_torch.checkpoint import save_v0

ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _children(pid: int) -> list[int]:
    out = []
    for task in Path(f"/proc/{pid}/task").iterdir():
        out += [int(c) for c in (task / "children").read_text().split()]
    return out


def _alive(pid: int) -> bool:
    try:
        return Path(f"/proc/{pid}/stat").read_text().split()[2] != "Z"
    except FileNotFoundError:
        return False


def _jax_stream(model, tok_path, jcfg, prompt, steps):
    params = jl.load_params(jcfg, random_params(jcfg, seed=21), dtype=jnp.float32)
    eng = JEngine(jcfg, params, JTok.from_file(tok_path, jcfg.vocab_size),
                  JEcfg(max_batch_size=2, tp_size=2))
    eng.start()
    try:
        r = JRequest(prompt=prompt, steps=steps, temperature=0.0, stop_at_eos=False)
        eng.submit(r)
        out = []
        while (t := r.queue.get(timeout=120)) is not None:
            out.append(t)
        return out
    finally:
        eng.stop()


@pytest.mark.parametrize("prompt,steps", [("abc", 8)])
def test_server_tp2_on_the_cpu_answers_gen_with_jaxs_stream(tmp_path, prompt, steps):
    jcfg = tiny_config(seq_len=32)
    model = tmp_path / "m.bin"
    save_v0(str(model), torch_cfg(jcfg), random_params(jcfg, seed=21))
    tok_path = write_tokenizer_bin(tmp_path / "tok.bin", jcfg.vocab_size)
    port = _free_port()
    server = subprocess.Popen(
        [sys.executable, "-m", "rama_tpu_torch.server.app", "-m", str(model), "-t", tok_path,
         "--device", "cpu", "--dtype", "float32", "--quant", "none", "--batch", "2",
         "--tp", "2", "--address", f"127.0.0.1:{port}"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                    assert json.load(r) == {"ok": True}
                break
            except OSError:
                assert server.poll() is None, server.communicate()[0][-4000:]
                assert time.time() < deadline, "the server did not come up"
                time.sleep(0.5)
        followers = [c for c in _children(server.pid) if _alive(c)]
        assert followers                           # rank 1 runs beside it
        url = f"{base}/gen?prompt={prompt}&steps={steps}&temperature=0"
        with urllib.request.urlopen(url, timeout=120) as r:
            lines = r.read().decode().splitlines()
        got = [ln[len("data: "):] for ln in lines if ln.startswith("data: ")]
        assert not any(ln.startswith("event: error") for ln in lines)
        server.send_signal(signal.SIGINT)
        out = server.communicate(timeout=120)[0]
        assert server.returncode == 0, out[-4000:]
        deadline = time.time() + 30
        while any(_alive(c) for c in followers) and time.time() < deadline:
            time.sleep(0.2)
        assert not any(_alive(c) for c in followers)   # stopped and joined
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate()
    want = _jax_stream(model, tok_path, jcfg, prompt, steps)
    assert "".join(got).replace("\\n", "\n") == "".join(want) and len(got) == steps
