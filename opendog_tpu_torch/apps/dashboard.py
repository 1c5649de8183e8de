"""Telemetry dashboards.

``render_terminal_dashboard`` — the terminal telemetry view of
``Code/examples/dasht.py:33``: per-ESP angles / encoder targets / DMP YPR in
a fixed-width text frame, refreshable in place.

``serve_web_dashboard``      — the Flask-SocketIO web dashboard of
``Code/examples/dash_viz.py:26-47`` re-done dependency-free: a tiny stdlib
HTTP server with an auto-refreshing JSON endpoint + HTML page.

A copy of the JAX package's ``apps/dashboard.py`` (which imports no JAX).
"""
from __future__ import annotations

import http.server
import json
import threading
from typing import Callable, Dict, Optional


def snapshot_from_body(body) -> Dict:
    """Collect both ESPs' stores into one dashboard snapshot."""
    out = {}
    for i in (0, 1):
        motor = body.get_latest_motor_data_for_esp(i) or {}
        dmp = body.get_latest_dmp_data_for_esp(i) or {}
        out[f"esp{i}"] = {
            "angles": motor.get("angles", [0.0] * 4),
            "targetPos": motor.get("targetPos", [0] * 4),
            "encoderPos": motor.get("encoderPos", [0] * 4),
            "enabled": motor.get("esp_control_fully_enabled", False),
            "ypr": dmp.get("ypr_deg", {}),
        }
    return out


def render_terminal_dashboard(snapshot: Dict) -> str:
    lines = ["=" * 62,
             "  OpenDOG telemetry".ljust(62),
             "=" * 62]
    for name, esp in snapshot.items():
        ypr = esp.get("ypr", {})
        lines.append(
            f"{name.upper()}  enabled={esp['enabled']}  "
            f"yaw={ypr.get('yaw', 0):7.2f} pitch={ypr.get('pitch', 0):7.2f} "
            f"roll={ypr.get('roll', 0):7.2f}"
        )
        ang = " ".join(f"{a:8.2f}" for a in esp["angles"])
        tgt = " ".join(f"{t:8d}" for t in esp["targetPos"])
        enc = " ".join(f"{e:8d}" for e in esp["encoderPos"])
        lines.append(f"  angles : {ang}")
        lines.append(f"  target : {tgt}")
        lines.append(f"  encoder: {enc}")
    lines.append("=" * 62)
    return "\n".join(lines)


_PAGE = b"""<!doctype html><html><head><title>OpenDOG dashboard</title>
<style>body{font-family:monospace;background:#111;color:#8f8}
td,th{padding:4px 10px;border:1px solid #333}</style></head><body>
<h2>OpenDOG telemetry</h2><div id="d">loading...</div>
<script>
async function tick(){
 const r = await fetch('/data'); const j = await r.json();
 let h = '';
 for (const [k,v] of Object.entries(j)) {
  h += `<h3>${k} (enabled: ${v.enabled})</h3><table><tr><th></th>`+
       [0,1,2,3].map(i=>`<th>M${i}</th>`).join('')+'</tr>'+
       `<tr><td>angle</td>${v.angles.map(a=>`<td>${a.toFixed(1)}</td>`).join('')}</tr>`+
       `<tr><td>target</td>${v.targetPos.map(a=>`<td>${a}</td>`).join('')}</tr>`+
       `<tr><td>encoder</td>${v.encoderPos.map(a=>`<td>${a}</td>`).join('')}</tr>`+
       `</table><p>ypr: ${JSON.stringify(v.ypr)}</p>`;
 }
 document.getElementById('d').innerHTML = h;
}
setInterval(tick, 250); tick();
</script></body></html>"""


def serve_web_dashboard(
    source: Callable[[], Dict], host: str = "127.0.0.1", port: int = 0
):
    """Start the dashboard HTTP server; returns (server, thread).  ``/``
    serves the page, ``/data`` the live JSON (dash_viz.py equivalent)."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/data":
                body = json.dumps(source()).encode()
                ctype = "application/json"
            else:
                body = _PAGE
                ctype = "text/html"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    server = http.server.ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread
