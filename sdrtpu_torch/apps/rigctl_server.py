"""Hamlib rigctl TCP server — ``misc_modules/rigctl_server`` capability
(PyTorch counterpart of ``sdrtpu/apps/rigctl_server.py``; host code).

Implements the NET rigctl command set the reference handles
(``rigctl_server/src/main.cpp:347-567``): F/f (set/get frequency),
M/m (set/get mode + bandwidth, incl. the "?" mode query), V/v
(set/get VFO), \\chk_vfo, s/S (split), compound single-letter commands,
AOS/LOS aka \\recorder_start/\\recorder_stop, \\dump_state, q/Q.
Drives tune/mode/record callbacks instead of module-comm.
"""

from __future__ import annotations

import socket
import threading

# rigctl mode names in RADIO_IFACE mode order (main.cpp:336-345; "FM"
# is the reference's name for NFM)
RIGCTL_MODES = ["FM", "WFM", "AM", "DSB", "USB", "CW", "LSB", "RAW"]

DUMP_STATE = (
    "0\n2\n2\n150000.000000 1500000000.000000 0x1ff -1 -1 0x10000003 0x3\n"
    "0 0 0 0 0 0 0\n0 0 0 0 0 0 0\n0x1ff 1\n0x1ff 0\n0 0\n0x1e 2400\n"
    "0x2 500\n0x1 8000\n0x1 2400\n0x20 15000\n0x20 8000\n0x40 230000\n"
    "0 0\n9990\n9990\n10000\n0\n10 \n10 20 30 \n0x3effffff\n0x3effffff\n"
    "0x7fffffff\n0x7fffffff\n0x7fffffff\n0x7fffffff\n"
)


class RigctlServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 4532,
        get_freq=None,
        set_freq=None,
        start_recorder=None,
        stop_recorder=None,
        get_mode=None,
        set_mode=None,
        get_bandwidth=None,
        set_bandwidth=None,
    ):
        self.get_freq = get_freq or (lambda: 0.0)
        self.set_freq = set_freq or (lambda f: None)
        self.start_recorder = start_recorder or (lambda: None)
        self.stop_recorder = stop_recorder or (lambda: None)
        # mode callbacks speak sdrtpu mode names ("nfm", "wfm", ...)
        self.get_mode = get_mode or (lambda: "raw")
        self.set_mode = set_mode or (lambda m: None)
        self.get_bandwidth = get_bandwidth or (lambda: 0.0)
        self.set_bandwidth = set_bandwidth or (lambda b: None)
        self._alive = True
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(1)
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1]

    def _accept_loop(self):
        while self._alive:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._client_loop, args=(conn,), daemon=True
            ).start()

    def _client_loop(self, conn: socket.socket):
        buf = b""
        while self._alive:
            try:
                data = conn.recv(4096)
            except OSError:
                break
            if not data:
                break
            buf += data
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                resp = self.handle_command(line.decode(errors="replace").strip())
                if resp is None:  # quit
                    conn.close()
                    return
                if resp:
                    try:
                        conn.sendall(resp.encode())
                    except OSError:
                        return
        conn.close()

    def handle_command(self, cmd: str) -> str | None:
        parts = [p for p in cmd.split(" ") if p]
        if not parts:
            return ""
        op = parts[0]
        # compound single-letter commands like "fF" (main.cpp:376-383)
        if len(op) > 1 and not op.startswith("\\") and op not in ("AOS", "LOS"):
            args = cmd[len(op):]
            out = []
            for c in op:
                r = self.handle_command(c + args)
                if r is None:
                    return None
                out.append(r)
            return "".join(out)

        if op in ("F", "\\set_freq"):
            try:
                self.set_freq(float(parts[1]))
                return "RPRT 0\n"
            except (IndexError, ValueError):
                return "RPRT -1\n"
        if op in ("f", "\\get_freq"):
            return f"{self.get_freq():.0f}\n"
        if op in ("M", "\\set_mode"):
            if len(parts) >= 2 and parts[1] == "?":
                return "FM WFM AM DSB USB CW LSB RAW\n"
            if len(parts) != 3:
                return "RPRT 1\n"
            mode, bw = parts[1], parts[2]
            if mode not in RIGCTL_MODES or not (
                bw.lstrip("-").isdigit() and bw.count("-") <= (
                    1 if bw.startswith("-") else 0
                )
            ):
                return "RPRT 1\n"
            self.set_mode(mode.lower() if mode != "FM" else "nfm")
            if int(bw) > 0:
                self.set_bandwidth(float(bw))
            return "RPRT 0\n"
        if op in ("m", "\\get_mode"):
            mode = (self.get_mode() or "raw").lower()
            name = "FM" if mode == "nfm" else mode.upper()
            if name not in RIGCTL_MODES:
                name = "RAW"
            return f"{name}\n{int(self.get_bandwidth() or 0)}\n"
        if op in ("V", "\\set_vfo"):
            if len(parts) != 2:
                return "RPRT 1\n"
            if parts[1] == "?":
                return "VFO\n"
            return "RPRT 0\n" if parts[1] == "VFO" else "RPRT 1\n"
        if op in ("v", "\\get_vfo"):
            return "VFO\n"
        if op == "\\chk_vfo":
            return "CHKVFO 0\n"
        if op == "s":  # split status
            return "0\nVFOA\n"
        if op == "S":
            return "RPRT 0\n"
        if op in ("AOS", "\\recorder_start"):
            self.start_recorder()
            return "RPRT 0\n"
        if op in ("LOS", "\\recorder_stop"):
            self.stop_recorder()
            return "RPRT 0\n"
        if op in ("\\dump_state",):
            return DUMP_STATE
        if op in ("q", "Q", "\\quit"):
            return None
        return "RPRT 0\n"

    def close(self):
        self._alive = False
        self._listener.close()
