"""Decode worker subprocess of ``decode_batch(backend='native_mp')`` (the
port's copy of vqa_tpu/data/_decode_worker.py).

The pool (``images._SubprocPool``) starts plain subprocesses that run
:func:`serve` over a binary stdin/stdout protocol:

  request:  b"REQ <n> <host_size> <synthetic:0|1>\\n" + n utf-8 path lines
  reply:    b"OK <n> <host_size>\\n" + n*S*S*3 raw uint8 bytes (NHWC rows)
        or  b"ERR <len>\\n" + <len> bytes of repr(exception)

A worker reads the whole request before it writes the reply, so the parent
can write every worker's (small) request first and then collect the (large)
replies without a pipe deadlock. Each worker decodes its chunk with the
native decoder on one thread (``backend='auto'``, so a file libjpeg rejects
falls back to PIL or the synthetic image): the parallelism is the pool's,
as in torch's DataLoader workers. A worker imports neither torch nor jax:
``vqa_tpu_torch.data.images`` (numpy, PIL, ctypes) is its only heavy import.
"""

from __future__ import annotations

import os
import sys


def serve() -> None:
    # A supervisor that preempts the job signals the whole process group,
    # this worker included; the parent's PreemptionGuard needs the worker to
    # serve the batch in flight so training reaches its step-boundary
    # checkpoint. So SIGTERM is ignored: the clean shutdown is the parent
    # closing stdin (readline -> b"" below), and SIGKILL still works.
    import signal
    try:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    except (ValueError, OSError):  # not the main thread
        pass
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    from vqa_tpu_torch.data.images import decode_batch

    while True:
        line = stdin.readline()
        if not line:
            return  # the parent closed the pipe: clean shutdown
        parts = line.split()
        if not parts or parts[0] != b"REQ":
            return
        n, host_size, synth = int(parts[1]), int(parts[2]), int(parts[3])
        paths = [os.fsdecode(stdin.readline().rstrip(b"\n")) for _ in range(n)]
        try:
            out = decode_batch(paths, host_size, synthetic_fallback=bool(synth),
                               backend="auto", native_threads=1)
            stdout.write(b"OK %d %d\n" % (out.shape[0], host_size))
            stdout.write(out.tobytes())
        except Exception as e:  # noqa: BLE001 - reported to the parent, which raises it
            msg = repr(e).encode("utf-8", "replace")[:1000]
            stdout.write(b"ERR %d\n" % len(msg))
            stdout.write(msg)
        stdout.flush()


if __name__ == "__main__":
    serve()
