"""Open-loop HTTP load: a process of its own that imports no torch.

Reads one JSON object on standard input: ``{"port", "k", "warm":
[texts], "requests": [[due_s, text], ...], "drain_s", "threads"}``. It
sends the warm-up requests one after another, prints ``ready``, then
waits for a line ``go <t0>`` (``time.monotonic()`` of the caller, the
same clock here) and sends each request at ``t0 + due_s`` on a pool of
threads, whether or not earlier ones have returned. It prints one JSON
line: per request ``[due_s, sent_s, done_s, status, hits]`` (times from
t0; ``done_s`` null and status 0 for a request that never came back
within ``drain_s`` of the last due time; ``hits`` the [[id, score]] of
a 200). Then it exits without waiting for threads still blocked.
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor


def get(port: int, text: str, k: int, timeout: float):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", "/search?" + urllib.parse.urlencode({"q": text, "k": k}))
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            return resp.status, None
        return 200, [[r["id"], r["score"]] for r in json.loads(body)["results"]]
    finally:
        conn.close()


def main() -> int:
    job = json.loads(sys.stdin.readline())
    port, k, drain = job["port"], job["k"], job["drain_s"]
    for text in job["warm"]:
        get(port, text, k, drain)
    print("ready", flush=True)
    line = sys.stdin.readline().split()
    t0 = float(line[1])
    reqs = job["requests"]
    out = [[due, None, None, 0, None] for due, _ in reqs]
    done = threading.Event()
    left = [len(reqs)]
    lock = threading.Lock()

    def one(i: int) -> None:
        rec = out[i]
        rec[1] = time.monotonic() - t0
        try:
            status, hits = get(port, reqs[i][1], k, drain)
        except Exception:  # noqa: BLE001 — a refused or broken request is a failure
            status, hits = -1, None
        t = time.monotonic() - t0
        with lock:
            rec[2], rec[3], rec[4] = t, status, hits
            left[0] -= 1
            if left[0] == 0:
                done.set()

    pool = ThreadPoolExecutor(max_workers=job["threads"])
    for i, (due, _) in enumerate(reqs):
        wait = t0 + due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        pool.submit(one, i)
    last = reqs[-1][0] if reqs else 0.0
    done.wait(timeout=max(0.0, t0 + last + drain - time.monotonic()))
    with lock:
        # a request still out is one that never came
        snap = [list(r) for r in out]
    sys.stdout.write(json.dumps(snap) + "\n")
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
