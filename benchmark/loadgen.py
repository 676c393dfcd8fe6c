"""The open-loop load generator: a process of its own, so that the
server's interpreter lock is the server's alone.

    python3 benchmark/loadgen.py '<json job>'

The job names the server (`host`, `port`), the run's `seed`, the mix's
`lengths`, `rate`, `upload_sr` and `peak`, `seconds`, `warm_s` and
`batch_max`.  The generator makes every request's upload first (gen.py),
then, as set-up, sends bursts of 2 to `batch_max` simultaneous uploads of
mixed lengths (so that every micro-batch size meets clips of several
lengths before the window) and `warm_s` seconds of the mix, all of other
clips, and waits for every answer; it prints "ready", reads the window's
start on standard input (a time.monotonic() value, which every
process of the machine shares), then sends request i at start + due_i
whether or not earlier requests have been answered, each on a connection
of its own.  It waits for every answer (`wait_s` at most past the window)
and prints one JSON object: per request its due and send times, the time
its full response was read, its HTTP status and its body.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time

import numpy as np

import gen


async def post(host: str, port: int, path: str, body: bytes) -> tuple[int, bytes]:
    reader, writer = await asyncio.open_connection(host, port)
    try:
        head = (f"POST {path} HTTP/1.1\r\nHost: {host}\r\nContent-Type: audio/wav\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n").encode()
        writer.write(head + body)
        await writer.drain()
        data = await reader.read()
    finally:
        writer.close()
    status_line, _, rest = data.partition(b"\r\n")
    _, _, payload = rest.partition(b"\r\n\r\n")
    return int(status_line.split()[1]), payload


async def drive(job: dict, bodies: list, due: list, start: float) -> list:
    out = [None] * len(bodies)
    path = job["path"]

    async def one(i: int):
        delay = start + due[i] - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        sent = time.monotonic()
        try:
            status, payload = await post(job["host"], job["port"], path, bodies[i])
        except (OSError, ValueError, IndexError) as e:
            status, payload = -1, str(e).encode()
        out[i] = {"due": due[i], "sent": sent - start, "done": time.monotonic() - start,
                  "status": status, "body": payload.decode("utf-8", "replace")}

    tasks = [asyncio.create_task(one(i)) for i in range(len(bodies))]
    done, pending = await asyncio.wait(tasks, timeout=job["seconds"] + job["wait_s"])
    for t in pending:
        t.cancel()
    for t in done:
        t.result()
    return out


WARM_OFFSET = 10**8  # warm-up request i carries clip WARM_OFFSET + i
BURST_GAP_S = 0.5


def schedule(job: dict, seconds: float, offset: int = 0) -> tuple[list, list, list]:
    """(due times, durations, upload bodies) of `seconds` of the mix; with
    an offset, the warm-up: its bursts first, then `seconds` of the mix."""
    due = gen.arrivals_s(job["rate"], seconds, job["lengths"]["shape_seed"] + offset)
    if offset:
        sizes = list(range(2, job["batch_max"] + 1)) * 2  # every micro-batch size, twice
        bursts = [BURST_GAP_S * b for b, k in enumerate(sizes) for _ in range(k)]
        due = np.concatenate([bursts, bursts[-1] + BURST_GAP_S + due])
    durs = gen.lengths_s(len(due), job["lengths"], offset)
    bodies = [gen.upload(job["seed"], offset + i, float(d), job["upload_sr"], job["peak"])
              for i, d in enumerate(durs)]
    return [float(d) for d in due], [float(d) for d in durs], bodies


def main() -> int:
    job = json.loads(sys.argv[1])
    due, durs, bodies = schedule(job, job["seconds"])
    if job["warm_s"] > 0:
        w_due, _, w_bodies = schedule(job, job["warm_s"], WARM_OFFSET)
        warm = asyncio.run(drive(job, w_bodies, w_due, time.monotonic() + 0.05))
        bad = [r for r in warm if r is None or r["status"] != 200]
        if bad:
            print(f"warm-up failed: {bad[0]}", flush=True)
            return 1
    print("ready", flush=True)
    start = float(sys.stdin.readline())
    results = asyncio.run(drive(job, bodies, due, start))
    json.dump({"durations_s": durs, "requests": results}, sys.stdout)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
