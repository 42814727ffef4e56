"""Interactive piano-roll plots as self-contained HTML (numpy and json
only): the port's own copy of ``music2midi_tpu/plot_interactive.py``, which
writes the same bytes for the same MidiFile.

A single .html file embeds the note data as JSON and a small vanilla-JS
canvas viewer:

  * hover: per-note tooltip (pitch name, velocity, onset, duration, class)
  * wheel: zoom time axis around the cursor; shift+wheel zooms pitch
  * drag: pan; double-click: reset view
  * legend with per-class toggling; PNG export button

``webui.py`` links one next to every result.
"""

from __future__ import annotations

import html as _html
import json
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from .midi import MidiFile
from .plot_midi import extract_melody_from_piano_roll, piano_roll_to_notes

_NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#",
               "B"]

_PALETTE = ["#3b82f6", "#f59e0b", "#10b981", "#8b5cf6", "#ec4899",
            "#14b8a6", "#f97316", "#6366f1"]

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;font:13px system-ui,sans-serif;background:#0f172a;color:#e2e8f0}
 #bar{display:flex;gap:12px;align-items:center;padding:8px 12px}
 #bar b{font-size:14px}
 .lg{display:flex;gap:4px;align-items:center;cursor:pointer;user-select:none}
 .sw{width:12px;height:12px;border-radius:2px;display:inline-block}
 .off .sw{opacity:.15}.off{color:#64748b}
 button{background:#1e293b;color:#e2e8f0;border:1px solid #334155;
        border-radius:4px;padding:3px 10px;cursor:pointer}
 #wrap{position:relative}
 canvas{display:block;width:100vw;height:calc(100vh - 40px)}
 #tip{position:absolute;pointer-events:none;background:#1e293bee;
      border:1px solid #334155;border-radius:4px;padding:5px 8px;
      display:none;white-space:pre;z-index:2}
</style></head><body>
<div id="bar"><b>__TITLE__</b><span id="legend"></span>
<button id="reset">reset</button><button id="save">save png</button>
<span style="color:#64748b">wheel: zoom &middot; shift+wheel: pitch zoom
&middot; drag: pan &middot; dblclick: reset</span></div>
<div id="wrap"><canvas id="cv"></canvas><div id="tip"></div></div>
<script>
const NOTES = __NOTES__, CLASSES = __CLASSES__;
const NAMES = ["C","C#","D","D#","E","F","F#","G","G#","A","A#","B"];
const cv = document.getElementById("cv"), ctx = cv.getContext("2d");
const tip = document.getElementById("tip");
const on = CLASSES.map(() => true);
let t0, t1, p0, p1;                       // view window
const tMax = Math.max(1e-6, ...NOTES.map(n => n.t1));
const ps = NOTES.map(n => n.p);
const pLo = NOTES.length ? Math.max(0, Math.min(...ps) - 4) : 40;
const pHi = NOTES.length ? Math.min(128, Math.max(...ps) + 5) : 90;
function reset(){ t0 = 0; t1 = tMax * 1.02; p0 = pLo; p1 = pHi; draw(); }
const ML = 44, MB = 26;                   // axis margins
function xw(){ return cv.width  / devicePixelRatio - ML; }
function yh(){ return cv.height / devicePixelRatio - MB; }
function xPix(t){ return ML + (t - t0) / (t1 - t0) * xw(); }
function yPix(p){ return (p1 - p) / (p1 - p0) * yh(); }
function draw(){
  const dpr = devicePixelRatio, W = cv.clientWidth, H = cv.clientHeight;
  if (cv.width !== W * dpr){ cv.width = W * dpr; cv.height = H * dpr; }
  ctx.setTransform(dpr, 0, 0, dpr, 0, 0);
  ctx.clearRect(0, 0, W, H);
  ctx.strokeStyle = "#1e293b"; ctx.fillStyle = "#475569";
  ctx.font = "10px system-ui";
  for (let p = Math.ceil(p0 / 12) * 12; p <= p1; p += 12){   // octave grid
    const y = yPix(p);
    ctx.beginPath(); ctx.moveTo(ML, y); ctx.lineTo(W, y); ctx.stroke();
    ctx.fillText(NAMES[p % 12] + (Math.floor(p / 12) - 1), 4, y + 3);
  }
  const step = Math.pow(10, Math.floor(Math.log10((t1 - t0) / 6)));
  const tick = (t1 - t0) / step > 30 ? step * 5 : step;
  for (let t = Math.ceil(t0 / tick) * tick; t <= t1; t += tick){
    const x = xPix(t);
    ctx.beginPath(); ctx.moveTo(x, 0); ctx.lineTo(x, yh()); ctx.stroke();
    ctx.fillText(t.toFixed(tick < 1 ? 1 : 0) + "s", x + 2, H - 8);
  }
  const hN = yh() / (p1 - p0);
  for (const n of NOTES){
    if (!on[n.c] || n.t1 < t0 || n.t0 > t1 || n.p < p0 || n.p > p1) continue;
    ctx.fillStyle = CLASSES[n.c].color;
    const x = xPix(n.t0);
    ctx.fillRect(x, yPix(n.p + 1) + 0.5,
                 Math.max(1.5, xPix(n.t1) - x - 0.5), Math.max(1, hN - 1));
  }
}
function pick(mx, my){
  const t = t0 + (mx - ML) / xw() * (t1 - t0);
  const p = p1 - my / yh() * (p1 - p0);
  let best = null;
  for (const n of NOTES)
    if (on[n.c] && t >= n.t0 && t <= n.t1 && p >= n.p && p < n.p + 1)
      best = n;
  return best;
}
let drag = null;
cv.onmousedown = e => { drag = {x: e.offsetX, y: e.offsetY, t0, t1, p0, p1}; };
window.onmouseup = () => { drag = null; };
cv.onmousemove = e => {
  if (drag){
    const dt = (drag.x - e.offsetX) / xw() * (drag.t1 - drag.t0);
    const dp = (e.offsetY - drag.y) / yh() * (drag.p1 - drag.p0);
    t0 = drag.t0 + dt; t1 = drag.t1 + dt;
    p0 = drag.p0 + dp; p1 = drag.p1 + dp;
    tip.style.display = "none"; draw(); return;
  }
  const n = pick(e.offsetX, e.offsetY);
  if (n){
    const name = NAMES[n.p % 12] + (Math.floor(n.p / 12) - 1);
    tip.textContent = name + " (" + n.p + ")  vel " + n.v +
      "\\n" + n.t0.toFixed(3) + "s  dur " + (n.t1 - n.t0).toFixed(3) + "s" +
      (CLASSES.length > 1 ? "\\n" + CLASSES[n.c].name : "");
    tip.style.left = (e.offsetX + 14) + "px";
    tip.style.top = (e.offsetY + 14) + "px";
    tip.style.display = "block";
  } else tip.style.display = "none";
};
cv.onwheel = e => {
  e.preventDefault();
  const f = Math.exp(e.deltaY * 0.0015);
  if (e.shiftKey){
    const c = p1 - e.offsetY / yh() * (p1 - p0);
    p0 = c + (p0 - c) * f; p1 = c + (p1 - c) * f;
  } else {
    const c = t0 + (e.offsetX - ML) / xw() * (t1 - t0);
    t0 = c + (t0 - c) * f; t1 = c + (t1 - c) * f;
  }
  draw();
};
cv.ondblclick = reset;
document.getElementById("reset").onclick = reset;
document.getElementById("save").onclick = () => {
  const a = document.createElement("a");
  a.download = "piano_roll.png"; a.href = cv.toDataURL(); a.click();
};
const lg = document.getElementById("legend");
CLASSES.forEach((c, i) => {
  const s = document.createElement("span");
  s.className = "lg";
  s.innerHTML = '<span class="sw" style="background:' + c.color +
                '"></span>' + c.name;
  s.onclick = () => { on[i] = !on[i]; s.classList.toggle("off"); draw(); };
  lg.appendChild(s);
});
window.onresize = draw;
reset();
</script></body></html>
"""


def _json_for_html(obj) -> str:
    """JSON safe to embed in an inline <script>: '<' escaped so a value
    containing '</script>' cannot terminate the block."""
    return json.dumps(obj, separators=(",", ":")).replace("<", "\\u003c")


def _render(notes: list, classes: list, title: str,
            path: Optional[Union[str, Path]]) -> str:
    html = (
        _TEMPLATE
        .replace("__TITLE__", _html.escape(str(title)))
        .replace("__NOTES__", _json_for_html(notes))
        .replace("__CLASSES__", _json_for_html(classes))
    )
    if path is not None:
        Path(path).write_text(html)
    return html


def plot_midi_sequence_html(
    midi: MidiFile,
    path: Optional[Union[str, Path]] = None,
    title: str = "piano roll",
) -> str:
    """Interactive piano roll of one MidiFile; one legend entry (and color)
    per instrument.  Returns the HTML string; writes it to `path` if given."""
    notes, classes = [], []
    for i, inst in enumerate(midi.instruments):
        classes.append({
            "name": inst.name or f"program {inst.program}",
            "color": _PALETTE[i % len(_PALETTE)],
        })
        for n in inst.notes:
            notes.append({
                "t0": round(float(n.start), 4), "t1": round(float(n.end), 4),
                "p": int(n.pitch), "v": int(n.velocity), "c": i,
            })
    notes.sort(key=lambda n: n["t0"])
    return _render(notes, classes or [{"name": "notes",
                                       "color": _PALETTE[0]}], title, path)


def plot_midi_evaluation_html(
    target: MidiFile,
    output: MidiFile,
    fs: int = 100,
    melody_only: bool = False,
    path: Optional[Union[str, Path]] = None,
    title: str = "target vs prediction",
) -> str:
    """Interactive TP / FN / FP diff roll.  Frame-level comparison at `fs`,
    rendered as run-length note rectangles."""
    end = max(target.get_end_time(), output.get_end_time())
    times = np.arange(0, end, 1 / fs)
    t_roll = target.get_piano_roll(fs=fs, times=times)
    o_roll = output.get_piano_roll(fs=fs, times=times)
    if melody_only:
        t_roll = extract_melody_from_piano_roll(t_roll)
        o_roll = extract_melody_from_piano_roll(o_roll)
    t_on, o_on = t_roll > 0, o_roll > 0
    classes = [
        {"name": "TP", "color": "#22c55e"},
        {"name": "FN (missed)", "color": "#f59e0b"},
        {"name": "FP (extra)", "color": "#ef4444"},
    ]
    vel = np.maximum(t_roll, o_roll)
    notes = []
    for ci, mask in enumerate((t_on & o_on, t_on & ~o_on, ~t_on & o_on)):
        for s, e, pitch, v in piano_roll_to_notes(
            np.where(mask, vel, 0.0), fs=fs
        ):
            notes.append({
                "t0": round(float(s), 4), "t1": round(float(e), 4),
                "p": int(pitch), "v": int(v), "c": ci,
            })
    notes.sort(key=lambda n: n["t0"])
    if melody_only:
        title += " (melody)"
    return _render(notes, classes, title, path)
