"""Single-file HTML/canvas viewer for replay-v4 episodes.

The reference ships mettascope (nim/mettascope — 18k LoC Nim GUI, replay
loader src/mettascope/replays.nim:7); this is the toolchain-free equivalent:
`write_viewer(replay, out_html)` embeds the episode JSON into a standalone
HTML page (no server, no dependencies) with a canvas grid, play/scrub
controls, per-object timelines resolved per step, and an inspector panel.
Validates the golden-pinned v4 format end-to-end for humans.
"""

from __future__ import annotations

import gzip
import json
import zlib
from pathlib import Path
from typing import Any, Dict, Union

_HTML_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>mettagrid-tpu replay</title>
<style>
  :root { color-scheme: dark; }
  body { margin: 0; font: 13px/1.4 system-ui, sans-serif; background: #14161a; color: #e6e6e6;
         display: grid; grid-template-columns: 1fr 300px; grid-template-rows: auto 1fr; height: 100vh; }
  #bar { grid-column: 1 / 3; display: flex; gap: 10px; align-items: center; padding: 8px 12px;
         background: #1d2026; border-bottom: 1px solid #2c313a; }
  #bar button { background: #2c313a; color: #e6e6e6; border: 1px solid #3a404c; border-radius: 4px;
                padding: 4px 10px; cursor: pointer; }
  #bar input[type=range] { flex: 1; }
  #stage { position: relative; overflow: hidden; }
  canvas { display: block; width: 100%; height: 100%; cursor: crosshair; }
  #side { border-left: 1px solid #2c313a; padding: 10px 12px; overflow-y: auto; background: #181b20; }
  #side h3 { margin: 4px 0 6px; font-size: 13px; color: #9ecbff; }
  #side table { border-collapse: collapse; width: 100%; }
  #side td { padding: 1px 4px; vertical-align: top; }
  #side td:first-child { color: #8a93a3; white-space: nowrap; }
  .legend-swatch { display: inline-block; width: 10px; height: 10px; border-radius: 2px; margin-right: 5px; }
</style>
</head>
<body>
<div id="bar">
  <button id="play">&#9654;</button>
  <button id="stepb">&minus;1</button>
  <button id="stepf">+1</button>
  <input type="range" id="scrub" min="0" value="0">
  <span id="stepno" style="min-width:90px"></span>
  <span id="meta" style="color:#8a93a3"></span>
</div>
<div id="stage"><canvas id="cv"></canvas></div>
<div id="side">
  <h3>Inspector</h3><div id="inspect">click an object</div>
  <h3>Legend</h3><div id="legend"></div>
</div>
<script>
// boot(R) renders one replay; returns mutators for live streaming
// (renderer/live_viewer.py appends timeline entries as the episode runs).
function boot(R) {
const [W, H] = R.map_size;
let maxStep = Math.max(1, (R.max_steps|0));
const objects = R.objects || [];

// Resolve a v4 field at step t: bare value, or [[step, value], ...] timeline.
function at(field, t) {
  if (!Array.isArray(field)) return field;
  if (!field.length || !Array.isArray(field[0]) || field[0].length !== 2 ||
      typeof field[0][0] !== "number") return field;  // a plain list value
  let v = field[0][1];
  for (const [s, val] of field) { if (s <= t) v = val; else break; }
  return v;
}
function hue(name) { let h = 0; for (const c of name) h = (h * 31 + c.charCodeAt(0)) % 360; return h; }
function typeColor(name) {
  if (name === "wall") return "#3a404c";
  return `hsl(${hue(name)} 55% 45%)`;
}

const cv = document.getElementById("cv"), ctx = cv.getContext("2d");
const scrub = document.getElementById("scrub"); scrub.max = maxStep - 1;
let step = 0, playing = false, selected = null;

function draw() {
  const stage = document.getElementById("stage");
  cv.width = stage.clientWidth; cv.height = stage.clientHeight;
  const s = Math.min(cv.width / W, cv.height / H);
  const ox = (cv.width - s * W) / 2, oy = (cv.height - s * H) / 2;
  ctx.fillStyle = "#14161a"; ctx.fillRect(0, 0, cv.width, cv.height);
  ctx.fillStyle = "#101215"; ctx.fillRect(ox, oy, s * W, s * H);
  ctx.strokeStyle = "#1c1f25"; ctx.lineWidth = 1;
  for (let x = 0; x <= W; x++) { ctx.beginPath(); ctx.moveTo(ox + x*s, oy); ctx.lineTo(ox + x*s, oy + H*s); ctx.stroke(); }
  for (let y = 0; y <= H; y++) { ctx.beginPath(); ctx.moveTo(ox, oy + y*s); ctx.lineTo(ox + W*s, oy + y*s); ctx.stroke(); }

  for (const o of objects) {
    if (at(o.alive, step) === false) continue;
    const loc = at(o.location, step); if (!loc) continue;
    const [x, y] = loc;
    const tname = at(o.type_name, step) || "?";
    const isAgent = !!at(o.is_agent, step);
    if (isAgent) {
      const gid = at(o.group_id, step) | 0;
      ctx.fillStyle = `hsl(${(gid * 77 + 200) % 360} 75% 60%)`;
      ctx.beginPath(); ctx.arc(ox + (x + .5) * s, oy + (y + .5) * s, s * .38, 0, 7); ctx.fill();
      const vibe = at(o.vibe_id, step) | 0;
      if (vibe) { ctx.strokeStyle = `hsl(${(vibe * 47) % 360} 90% 60%)`; ctx.lineWidth = Math.max(1, s * .08);
        ctx.beginPath(); ctx.arc(ox + (x + .5) * s, oy + (y + .5) * s, s * .46, 0, 7); ctx.stroke(); }
      if (s > 12) { ctx.fillStyle = "#0b0d10"; ctx.font = `${Math.floor(s * .4)}px system-ui`;
        ctx.textAlign = "center"; ctx.textBaseline = "middle";
        ctx.fillText(String(at(o.agent_id, step)), ox + (x + .5) * s, oy + (y + .55) * s); }
    } else {
      ctx.fillStyle = typeColor(tname);
      ctx.fillRect(ox + x * s + 1, oy + y * s + 1, s - 2, s - 2);
      const inv = at(o.inventory, step);
      if (Array.isArray(inv) && inv.length && s > 10) {
        ctx.fillStyle = "#ffd34d"; ctx.beginPath();
        ctx.arc(ox + (x + .78) * s, oy + (y + .22) * s, s * .12, 0, 7); ctx.fill();
      }
    }
    if (selected === o) { ctx.strokeStyle = "#9ecbff"; ctx.lineWidth = 2;
      ctx.strokeRect(ox + x * s, oy + y * s, s, s); }
  }
  document.getElementById("stepno").textContent = `step ${step} / ${maxStep - 1}`;
  scrub.value = step;
  cv._geom = { s, ox, oy };
  renderInspect();
}

function renderInspect() {
  const el = document.getElementById("inspect");
  if (!selected) { el.textContent = "click an object"; return; }
  const o = selected, rows = [];
  const items = R.item_names || [];
  const fields = ["id", "type_name", "location", "agent_id", "group_id", "action_id",
                  "action_success", "current_reward", "total_reward", "vibe", "tag_ids"];
  for (const f of fields) {
    if (!(f in o)) continue;
    let v = at(o[f], step);
    if (f === "action_id" && R.action_names) v = R.action_names[v] ?? v;
    rows.push(`<tr><td>${f}</td><td>${JSON.stringify(v)}</td></tr>`);
  }
  const inv = at(o.inventory, step);
  if (Array.isArray(inv)) {
    const txt = inv.map(([i, n]) => `${items[i] ?? i}:${n}`).join(", ") || "&mdash;";
    rows.push(`<tr><td>inventory</td><td>${txt}</td></tr>`);
  }
  el.innerHTML = `<table>${rows.join("")}</table>`;
}

cv.addEventListener("click", (ev) => {
  const { s, ox, oy } = cv._geom || {};
  if (!s) return;
  const x = Math.floor((ev.offsetX - ox) / s), y = Math.floor((ev.offsetY - oy) / s);
  selected = null;
  for (const o of objects) {
    if (at(o.alive, step) === false) continue;
    const loc = at(o.location, step);
    if (loc && loc[0] === x && loc[1] === y) selected = o;
  }
  draw();
});
document.getElementById("play").onclick = () => { playing = !playing;
  document.getElementById("play").innerHTML = playing ? "&#10074;&#10074;" : "&#9654;"; };
document.getElementById("stepf").onclick = () => { step = Math.min(maxStep - 1, step + 1); draw(); };
document.getElementById("stepb").onclick = () => { step = Math.max(0, step - 1); draw(); };
scrub.oninput = () => { step = scrub.value | 0; draw(); };
setInterval(() => { if (playing) { step = (step + 1) % maxStep; draw(); } }, 120);
window.addEventListener("resize", draw);

const legend = document.getElementById("legend");
legend.innerHTML = (R.type_names || []).map(t =>
  `<div><span class="legend-swatch" style="background:${typeColor(t)}"></span>${t}</div>`).join("");
document.getElementById("meta").textContent =
  `${W}x${H} · ${R.num_agents} agents · v${R.version}`;
draw();
// Live-mode mutators: extend per-object timelines in place and advance the
// view when it was following the tail.
return {
  applyStep(n, newObjects, deltas) {
    const follow = (step >= maxStep - 1);
    for (const o of newObjects) objects.push(o);
    for (const [idx, fields] of deltas) {
      const o = objects[idx]; if (!o) continue;
      for (const k in fields) {
        if (Array.isArray(o[k]) && Array.isArray(o[k][0])) { o[k].push([n, fields[k]]); continue; }
        // first appearance of a field mid-episode (replay_writer._seq_key_merge)
        const v = fields[k];
        const d = Array.isArray(v) ? [] : (typeof v === "boolean" ? false :
                  (typeof v === "number" ? 0 : ""));
        o[k] = n === 0 ? [[0, v]] : [[0, d], [n, v]];
      }
    }
    maxStep = Math.max(maxStep, n + 1);
    scrub.max = maxStep - 1;
    if (follow) step = maxStep - 1;
    draw();
  },
};
}
if (typeof __LIVE__ === "undefined") boot(__REPLAY_DATA__);
</script>
</body>
</html>
"""


def write_viewer(replay: Union[str, Path, Dict[str, Any]], out_html: Union[str, Path]) -> Path:
    """Embed a replay-v4 episode into a standalone HTML viewer.

    replay: a dict (ReplayWriter.finalize() output), or a path to a replay
    file — raw .json, zlib-compressed .json.z, or gzip .json.gz (the two
    compressions ReplayWriter emits).
    """
    if isinstance(replay, (str, Path)):
        raw = Path(replay).read_bytes()
        if raw[:2] == b"\x1f\x8b":
            raw = gzip.decompress(raw)
        elif raw[:1] == b"\x78":
            raw = zlib.decompress(raw)
        data = json.loads(raw.decode("utf-8"))
    else:
        data = replay
    if data.get("version") != 4:
        raise ValueError(f"expected replay format v4, got {data.get('version')!r}")
    # </script> inside JSON strings would terminate the inline script block.
    payload = json.dumps(data, separators=(",", ":")).replace("</", "<\\/")
    html = _HTML_TEMPLATE.replace("__REPLAY_DATA__", payload)
    out = Path(out_html)
    out.write_text(html, encoding="utf-8")
    return out


def main() -> None:
    """CLI: python -m mettagrid_tpu_torch.renderer.replay_viewer <replay> [out.html]"""
    import sys

    if len(sys.argv) < 2:
        print(__doc__)
        raise SystemExit(2)
    src = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 else str(Path(src).with_suffix("")) + ".html"
    path = write_viewer(src, out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
