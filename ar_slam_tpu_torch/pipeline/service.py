# Copied from ar_slam_tpu/pipeline/service.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Load-images / make-map control service: the TPU-native replacement for
the reference's ROS service plane.

The reference exposes ``LoadImages.srv`` (string[] img_fns -> bool success +
string message, ar_slam_interfaces/srv/LoadImages.srv) served by ImageLoader
(image_loader.cpp:125-133: append filenames to a mutex-guarded deque, the
wall timer drains one per tick) and called by ``load_images_client``
(ar_slam_module.py:8-20).  DDS is replaced by a Unix-domain socket speaking
one JSON object per line; the filename queue and success/message response
contract are preserved.

``MakeMap.srv`` (string[] img_fns -> string yaml) is DECLARED by the
reference (ar_slam_interfaces/CMakeLists.txt:21) but no node implements it;
here it is a real request type: {"make_map": true, "img_fns": [...]} builds
a standalone map from just those images and returns its YAML text.  The
response is deferred — the connection parks until the serve loop (which
owns the engine) fulfils it.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from collections import deque


class LoadImagesServer:
    """Accepts {"img_fns": [...]} requests and queues the filenames.

    The serve loop drains the queue via ``pop_batch``; requests get
    {"success": bool, "message": str} back, mirroring the srv response
    fields.  Requests with no filenames fail like the client does
    (load_images_client.py:30-40 errors on empty args).
    """

    def __init__(self, sock_path: str):
        self.sock_path = sock_path
        self._queue: deque[str] = deque()
        self._make_map: deque[tuple[socket.socket, list[str]]] = deque()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(sock_path)
        self._sock.listen(8)
        self._sock.settimeout(0.2)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                # a silent/partial client must not wedge the (single-
                # threaded) accept loop
                conn.settimeout(2.0)
                data = b""
                while not data.endswith(b"\n"):
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    data += chunk
                req = json.loads(data.decode())
                fns = [str(f) for f in req.get("img_fns", [])]
                if req.get("make_map"):
                    if not fns:
                        resp = {"success": False,
                                "message": "no filenames provided"}
                    else:
                        # park the connection: the serve loop owns the
                        # engine and fulfils the request via pop_make_map.
                        # Keep a send timeout — a client that stops reading
                        # must not wedge the serve loop in sendall.
                        conn.settimeout(30.0)
                        with self._lock:
                            self._make_map.append((conn, fns))
                        continue
                elif not fns:
                    resp = {"success": False,
                            "message": "no filenames provided"}
                else:
                    with self._lock:
                        self._queue.extend(fns)
                    resp = {"success": True,
                            "message": f"queued {len(fns)} images"}
            except Exception as e:  # malformed request — report, keep serving
                resp = {"success": False, "message": f"bad request: {e}"}
            try:
                conn.sendall((json.dumps(resp) + "\n").encode())
            except OSError:
                pass
            finally:
                conn.close()

    def pop_batch(self, max_items: int = 0) -> list[str]:
        """Drain up to max_items queued filenames (0 = all)."""
        out = []
        with self._lock:
            while self._queue and (not max_items or len(out) < max_items):
                out.append(self._queue.popleft())
        return out

    def has_make_map(self) -> bool:
        with self._lock:
            return bool(self._make_map)

    def pop_make_map(self):
        """Drain pending make_map requests as (respond, img_fns) pairs.
        ``respond(dict)`` sends the JSON response and closes the client."""
        out = []
        with self._lock:
            items = list(self._make_map)
            self._make_map.clear()

        def make_responder(conn):
            def respond(resp: dict):
                try:
                    conn.sendall((json.dumps(resp) + "\n").encode())
                except OSError:
                    pass
                finally:
                    conn.close()

            return respond

        for conn, fns in items:
            out.append((make_responder(conn), fns))
        return out

    def close(self):
        self._stop.set()
        self._sock.close()
        self._thread.join(timeout=2.0)
        with self._lock:
            for conn, _ in self._make_map:
                try:
                    conn.close()
                except OSError:
                    pass
            self._make_map.clear()
        if os.path.exists(self.sock_path):
            os.unlink(self.sock_path)


def _request(sock_path: str, payload: dict, timeout: float) -> dict:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(sock_path)
        s.sendall((json.dumps(payload) + "\n").encode())
        data = b""
        while not data.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    return json.loads(data.decode())


def send_load_images(sock_path: str, img_fns: list[str],
                     timeout: float = 10.0) -> dict:
    """Client call (≙ LoadImagesClientAsync.send_request): send the filename
    list, return the response dict."""
    return _request(sock_path, {"img_fns": list(img_fns)}, timeout)


def send_make_map(sock_path: str, img_fns: list[str],
                  timeout: float = 600.0) -> dict:
    """MakeMap client call (≙ MakeMap.srv: img_fns -> yaml).  Long default
    timeout: the serve loop detects + solves before responding."""
    return _request(sock_path, {"make_map": True, "img_fns": list(img_fns)},
                    timeout)
