"""Multi-process execution of the port on the CPU, as a torchrun launch
runs it: two ``python -m whisperx_tpu_torch --device cpu`` processes with
torchrun's variables split three 2 s clips (strided, disjoint, covering;
each output written by the process that owns its file), beside two
processes that join one gloo group through ``initialize_multihost`` and run
a real collective. Mirrors ``tests/test_multihost_exec.py``."""

import os
import socket
import subprocess
import sys
import textwrap

from conftest import synth_speech
from whisperx_tpu_torch.audio.io import save_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "PYTHONPATH")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)
    return env


def test_two_process_shard_transcribe_write_and_gloo_collective(tmp_path):
    wavs = []
    for i in range(3):
        path = str(tmp_path / f"clip{i}.wav")
        save_wav(path, synth_speech(2.0, seed=i))
        wavs.append(path)
    port = _free_port()
    cli = [
        subprocess.Popen(
            [sys.executable, "-m", "whisperx_tpu_torch", *wavs, "--device", "cpu",
             "--model", "test-nano", "--vad_method", "energy", "--language", "en",
             "--no_align", "--beam_size", "1", "--temperature_increment_on_fallback", "None",
             "-f", "json", "-o", str(tmp_path / f"out{rank}")],
            env=_env(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
            cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in (0, 1)
    ]
    group = textwrap.dedent(
        f"""
        import sys, torch, torch.distributed as dist
        from whisperx_tpu_torch.parallel import initialize_multihost, shard_files
        pid = int(sys.argv[1])
        got = initialize_multihost("127.0.0.1:{_free_port()}", num_processes=2, process_id=pid)
        assert got == (pid, 2), got
        assert initialize_multihost() == got  # a second call joins nothing
        x = torch.tensor([pid + 1.0])
        dist.all_reduce(x)
        print("sum", int(x.item()), shard_files(["a", "b", "c"]))
        dist.destroy_process_group()
        """
    )
    gloo = [
        subprocess.Popen([sys.executable, "-c", group, str(pid)], env=_env(), cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)
    ]
    outs = []
    for p in cli + gloo:
        try:
            outs.append(p.communicate(timeout=TIMEOUT))
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(cli + gloo, outs):
        assert p.returncode == 0, f"{so[-1000:]}\n{se[-3000:]}"

    assert ">>Host 0/2: 2 of 3 files" in outs[0][0]
    assert ">>Host 1/2: 1 of 3 files" in outs[1][0]
    owned = [sorted(os.listdir(tmp_path / f"out{rank}")) for rank in (0, 1)]
    # strided, disjoint, covering; each file's output in its owner's directory
    assert owned == [["clip0.json", "clip2.json"], ["clip1.json"]]
    assert outs[2][0].split() == ["sum", "3", "['a',", "'c']"]
    assert outs[3][0].split() == ["sum", "3", "['b']"]
