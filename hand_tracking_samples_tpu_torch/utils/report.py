"""Self-contained HTML report over the offline artifacts.

The reference's GL shell gives three interactions this framework replaces
offline: scrubbing recorded frames (annotation-fixer.cpp scrub UI), orbiting
the hand mesh (geometric.h:330 VirtualTrackBall), and side-by-side debug
images (misc_gl.h drawimage panes).  write_html_report() scans an artifact
directory (PNGs from apps' --dump-png, OBJs from model.meshes.export_obj)
and writes ONE dependency-free index.html next to them:

  * every PNG series (common prefix + frame number) becomes a scrubber with
    a slider, arrow-key stepping and play/pause;
  * every OBJ becomes an inline wireframe viewer (vanilla-JS canvas renderer
    with a trackball orbit + wheel zoom — no WebGL, no network; the mesh
    data is embedded in the page itself, so it works from file:// where
    browsers block fetch());
  * loose PNGs render as a plain gallery.

Open the file in any browser; images use relative paths, so the artifact
directory can be zipped and shared as-is.  The port's counterpart of
hand_tracking_samples_tpu.utils.report (the same page; the editor's "apply
with" line names the port's annotate CLI).
"""
from __future__ import annotations

import html as _html
import os
import re

_SERIES_RE = re.compile(r"^(.*?)(\d+)\.png$")

_PAGE = """<!doctype html>
<meta charset="utf-8">
<title>hand_tracking_samples_tpu report</title>
<style>
 body {{ font: 14px system-ui, sans-serif; margin: 1.2em; background: #16181c;
        color: #dde1e6; }}
 h1 {{ font-size: 1.25em; }} h2 {{ font-size: 1.05em; margin: 1.4em 0 .4em; }}
 .panel {{ background: #1f2228; border-radius: 8px; padding: .8em;
          margin-bottom: 1em; display: inline-block; vertical-align: top;
          margin-right: 1em; }}
 img.frame {{ image-rendering: pixelated; max-width: 640px; display: block; }}
 canvas {{ background: #101114; border-radius: 4px; touch-action: none; }}
 input[type=range] {{ width: 320px; vertical-align: middle; }}
 button {{ background: #2d3340; color: inherit; border: 0; border-radius: 4px;
          padding: .25em .7em; cursor: pointer; }}
 .lbl {{ color: #8b93a1; font-size: .85em; }}
</style>
<h1>hand_tracking_samples_tpu — artifact report</h1>
<p class=lbl>generated by utils/report.py; arrows step the focused scrubber,
 space toggles play, drag an OBJ canvas to orbit (wheel zooms).</p>
{body}
<script>
function scrub(id, files) {{
  const img = document.getElementById(id + '-img');
  const sl = document.getElementById(id + '-sl');
  const lab = document.getElementById(id + '-lab');
  const btn = document.getElementById(id + '-btn');
  let timer = null;
  function show(i) {{
    i = Math.max(0, Math.min(files.length - 1, i|0));
    sl.value = i; img.src = files[i];
    lab.textContent = files[i] + '  (' + (i+1) + '/' + files.length + ')';
  }}
  sl.addEventListener('input', () => show(+sl.value));
  btn.addEventListener('click', () => {{
    if (timer) {{ clearInterval(timer); timer = null; btn.textContent = 'play'; }}
    else {{ timer = setInterval(() =>
      show((+sl.value + 1) % files.length), 120); btn.textContent = 'pause'; }}
  }});
  sl.addEventListener('keydown', e => {{
    if (e.key === ' ') {{ btn.click(); e.preventDefault(); }}
  }});
  show(0);
}}
function objview(id, verts, edges) {{
  const cv = document.getElementById(id);
  const ctx = cv.getContext('2d');
  let center = [0,0,0], scale = 1;
  let q = [0,0,0,1], zoom = 1, drag = null;
  function qmul(a,b) {{ return [
    a[3]*b[0]+a[0]*b[3]+a[1]*b[2]-a[2]*b[1],
    a[3]*b[1]-a[0]*b[2]+a[1]*b[3]+a[2]*b[0],
    a[3]*b[2]+a[0]*b[1]-a[1]*b[0]+a[2]*b[3],
    a[3]*b[3]-a[0]*b[0]-a[1]*b[1]-a[2]*b[2]]; }}
  function qrot(q,v) {{
    const u=[q[0],q[1],q[2]], s=q[3];
    const c1=[u[1]*v[2]-u[2]*v[1], u[2]*v[0]-u[0]*v[2], u[0]*v[1]-u[1]*v[0]];
    const c2=[u[1]*c1[2]-u[2]*c1[1], u[2]*c1[0]-u[0]*c1[2], u[0]*c1[1]-u[1]*c1[0]];
    return [v[0]+2*(s*c1[0]+c2[0]), v[1]+2*(s*c1[1]+c2[1]), v[2]+2*(s*c1[2]+c2[2])];
  }}
  // VirtualTrackBall (geometric.h:330): map drag to a sphere rotation
  function ball(x, y) {{
    const r = Math.min(cv.width, cv.height) / 2;
    let vx = (x - cv.width/2)/r, vy = -(y - cv.height/2)/r;
    const d2 = vx*vx + vy*vy;
    const vz = d2 < 1 ? Math.sqrt(1 - d2) : 0;
    const n = Math.sqrt(vx*vx + vy*vy + vz*vz) || 1;
    return [vx/n, vy/n, vz/n];
  }}
  function draw() {{
    ctx.clearRect(0,0,cv.width,cv.height);
    ctx.strokeStyle = '#6ee7a8'; ctx.lineWidth = 1; ctx.beginPath();
    const s = scale * zoom, W = cv.width/2, H = cv.height/2;
    const p = verts.map(v => {{
      const r = qrot(q, [v[0]-center[0], v[1]-center[1], v[2]-center[2]]);
      const persp = 2.2 / (2.2 + r[2]*s/W);
      return [W + r[0]*s*persp, H - r[1]*s*persp];
    }});
    for (const [a,b] of edges) {{
      ctx.moveTo(p[a][0], p[a][1]); ctx.lineTo(p[b][0], p[b][1]);
    }}
    ctx.stroke();
  }}
  cv.addEventListener('pointerdown', e => {{
    drag = ball(e.offsetX, e.offsetY); cv.setPointerCapture(e.pointerId); }});
  cv.addEventListener('pointermove', e => {{
    if (!drag) return;
    const b = ball(e.offsetX, e.offsetY);
    const axis = [drag[1]*b[2]-drag[2]*b[1], drag[2]*b[0]-drag[0]*b[2],
                  drag[0]*b[1]-drag[1]*b[0]];
    const dot = Math.max(-1, Math.min(1, drag[0]*b[0]+drag[1]*b[1]+drag[2]*b[2]));
    const n = Math.sqrt(axis[0]**2+axis[1]**2+axis[2]**2);
    if (n > 1e-6) {{
      const ang = Math.acos(dot), s2 = Math.sin(ang/2)/n;
      q = qmul([axis[0]*s2, axis[1]*s2, axis[2]*s2, Math.cos(ang/2)], q);
    }}
    drag = b; draw();
  }});
  cv.addEventListener('pointerup', () => drag = null);
  cv.addEventListener('wheel', e => {{
    zoom *= Math.exp(-e.deltaY * 0.001); draw(); e.preventDefault(); }});
  if (!verts.length) return;
  const lo = [1e9,1e9,1e9], hi = [-1e9,-1e9,-1e9];
  for (const v of verts) for (let c = 0; c < 3; c++) {{
    lo[c] = Math.min(lo[c], v[c]); hi[c] = Math.max(hi[c], v[c]); }}
  center = [0,1,2].map(c => (lo[c]+hi[c])/2);
  const ext = Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2]) || 1;
  scale = 0.8 * cv.width / ext;
  draw();
}}
// Annotation editor (the fixer's drag-bone/hold/delete loop,
// annotation-fixer.cpp:219-260, offline): drag bone origins to world
// targets, mark holds/deletes, export an edits JSON consumed by
// `python -m ...apps.annotate --edits edits.json`.
function editview(id, frames) {{
  const cv = document.getElementById(id);
  const ctx = cv.getContext('2d');
  const sl = document.getElementById(id + '-sl');
  const lab = document.getElementById(id + '-lab');
  const mode = () => document.querySelector(
    'input[name=' + id + '-mode]:checked').value;
  const ta = document.getElementById(id + '-json');
  const dl = document.getElementById(id + '-dl');
  let q = [0,0,0,1], zoom = 1, drag = null, sel = -1, fi = 0;
  const edits = [];   // {{frame, bone, nail}} | {{frame, hold}} | {{frame, delete}}
  function qmul(a,b) {{ return [
    a[3]*b[0]+a[0]*b[3]+a[1]*b[2]-a[2]*b[1],
    a[3]*b[1]-a[0]*b[2]+a[1]*b[3]+a[2]*b[0],
    a[3]*b[2]+a[0]*b[1]-a[1]*b[0]+a[2]*b[3],
    a[3]*b[3]-a[0]*b[0]-a[1]*b[1]-a[2]*b[2]]; }}
  function qrot(q,v) {{
    const u=[q[0],q[1],q[2]], s=q[3];
    const c1=[u[1]*v[2]-u[2]*v[1], u[2]*v[0]-u[0]*v[2], u[0]*v[1]-u[1]*v[0]];
    const c2=[u[1]*c1[2]-u[2]*c1[1], u[2]*c1[0]-u[0]*c1[2], u[0]*c1[1]-u[1]*c1[0]];
    return [v[0]+2*(s*c1[0]+c2[0]), v[1]+2*(s*c1[1]+c2[1]), v[2]+2*(s*c1[2]+c2[2])];
  }}
  function qconj(q) {{ return [-q[0], -q[1], -q[2], q[3]]; }}
  let center = [0,0,0], scale = 1;
  {{
    const lo = [1e9,1e9,1e9], hi = [-1e9,-1e9,-1e9];
    for (const fr of frames) for (const v of fr.bones)
      for (let c = 0; c < 3; c++) {{
        lo[c] = Math.min(lo[c], v[c]); hi[c] = Math.max(hi[c], v[c]); }}
    center = [0,1,2].map(c => (lo[c]+hi[c])/2);
    const ext = Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2]) || 1;
    scale = 0.7 * cv.width / ext;
  }}
  function bonePos(b) {{
    for (const e of edits)
      if (e.frame === frames[fi].frame && e.bone === b && e.nail) return e.nail;
    return frames[fi].bones[b];
  }}
  function proj(v) {{
    const r = qrot(q, [v[0]-center[0], v[1]-center[1], v[2]-center[2]]);
    const s = scale * zoom;
    return [cv.width/2 + r[0]*s, cv.height/2 - r[1]*s];
  }}
  function draw() {{
    ctx.clearRect(0,0,cv.width,cv.height);
    const f = frames[fi];
    const del = edits.some(e => e.frame === f.frame && e.delete);
    const hold = edits.find(e => e.frame === f.frame && 'hold' in e);
    for (let b = 0; b < f.bones.length; b++) {{
      const nailed = edits.some(e => e.frame === f.frame && e.bone === b && e.nail);
      const p = proj(bonePos(b));
      ctx.fillStyle = b === sel ? '#ffd34d' : (nailed ? '#ff8c5a' : '#6ee7a8');
      ctx.beginPath(); ctx.arc(p[0], p[1], b === sel ? 6 : 4, 0, 7); ctx.fill();
      ctx.fillStyle = '#8b93a1'; ctx.font = '10px system-ui';
      ctx.fillText(b, p[0] + 6, p[1] - 6);
    }}
    lab.textContent = 'frame ' + f.frame + ' (' + (fi+1) + '/' + frames.length
      + ')  sel bone: ' + (sel < 0 ? 'none' : sel)
      + (del ? '  [DELETE]' : '') + (hold ? '  [hold ' + hold.hold + ']' : '');
  }}
  function exportEdits() {{
    const js = JSON.stringify({{edits: edits}}, null, 1);
    ta.value = js;
    dl.href = 'data:application/json,' + encodeURIComponent(js);
    draw();
  }}
  cv.addEventListener('pointerdown', e => {{
    if (mode() === 'drag') {{
      let best = 1e9;
      const f = frames[fi];
      for (let b = 0; b < f.bones.length; b++) {{
        const p = proj(bonePos(b));
        const d = (p[0]-e.offsetX)**2 + (p[1]-e.offsetY)**2;
        if (d < best) {{ best = d; sel = b; }}
      }}
      if (best > 20*20) sel = -1;
    }}
    drag = [e.offsetX, e.offsetY]; cv.setPointerCapture(e.pointerId); draw();
  }});
  cv.addEventListener('pointermove', e => {{
    if (!drag) return;
    const dx = e.offsetX - drag[0], dy = e.offsetY - drag[1];
    drag = [e.offsetX, e.offsetY];
    if (mode() === 'drag' && sel >= 0) {{
      const s = scale * zoom;
      const w = qrot(qconj(q), [dx/s, -dy/s, 0]);
      const cur = bonePos(sel);
      const nail = [cur[0]+w[0], cur[1]+w[1], cur[2]+w[2]];
      const f = frames[fi].frame;
      const ix = edits.findIndex(x => x.frame === f && x.bone === sel && x.nail);
      if (ix >= 0) edits[ix].nail = nail;
      else edits.push({{frame: f, bone: sel, nail: nail}});
      exportEdits();
    }} else {{
      // orbit: small-angle trackball
      const ax = [dy * 0.01, dx * 0.01, 0];
      const n = Math.hypot(ax[0], ax[1]) || 1e-9;
      const h = n / 2;
      q = qmul([ax[0]/n*Math.sin(h), ax[1]/n*Math.sin(h), 0, Math.cos(h)], q);
      draw();
    }}
  }});
  cv.addEventListener('pointerup', () => drag = null);
  cv.addEventListener('wheel', e => {{
    zoom *= Math.exp(-e.deltaY * 0.001); draw(); e.preventDefault(); }});
  sl.addEventListener('input', () => {{ fi = +sl.value; draw(); }});
  document.getElementById(id + '-hold1').addEventListener('click', () => {{
    edits.push({{frame: frames[fi].frame, hold: 1}}); exportEdits(); }});
  document.getElementById(id + '-hold2').addEventListener('click', () => {{
    edits.push({{frame: frames[fi].frame, hold: 2}}); exportEdits(); }});
  document.getElementById(id + '-del').addEventListener('click', () => {{
    edits.push({{frame: frames[fi].frame, delete: true}}); exportEdits(); }});
  document.getElementById(id + '-clear').addEventListener('click', () => {{
    const f = frames[fi].frame;
    for (let i = edits.length - 1; i >= 0; i--)
      if (edits[i].frame === f) edits.splice(i, 1);
    exportEdits();
  }});
  exportEdits();
}}
{init}
</script>
"""


_BONES_RE = re.compile(r"^bones_(\d+)\.json$")


def _scan(artifact_dir: str):
    pngs, objs, bones = [], [], []
    for name in sorted(os.listdir(artifact_dir)):
        if name.lower().endswith(".png"):
            pngs.append(name)
        elif name.lower().endswith(".obj"):
            objs.append(name)
        elif _BONES_RE.match(name):
            bones.append(name)
    bones.sort(key=lambda n: int(_BONES_RE.match(n).group(1)))
    series: dict[str, list[str]] = {}
    loose = []
    for n in pngs:
        m = _SERIES_RE.match(n)
        if m:
            series.setdefault(m.group(1) or "frames_", []).append(n)
        else:
            loose.append(n)
    for k in list(series):
        if len(series[k]) < 2:
            loose.extend(series.pop(k))
        else:
            # Numeric frame order: frame_2 before frame_10 even unpadded.
            series[k].sort(key=lambda n: int(_SERIES_RE.match(n).group(2)))
    return series, loose, objs, bones


def _parse_obj(path: str):
    """Vertices + unique wireframe edges of an OBJ, for inline embedding
    (browsers block fetch() on file:// pages, so the viewer can't load the
    mesh at runtime)."""
    verts, edges, seen = [], [], set()
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([round(float(c), 5) for c in t[1:4]])
            elif t[0] == "f":
                ix = [int(w.split("/")[0]) - 1 for w in t[1:]]
                for i, a in enumerate(ix):
                    b = ix[(i + 1) % len(ix)]
                    k = (min(a, b), max(a, b))
                    if k not in seen:
                        seen.add(k)
                        edges.append([a, b])
    return verts, edges


def write_html_report(artifact_dir: str, out_name: str = "index.html") -> str:
    """Scan `artifact_dir` and write the viewer page. Returns its path."""
    import json

    series, loose, objs, bones = _scan(artifact_dir)
    body, init = [], []
    if bones:
        frames = []
        for n in bones:
            with open(os.path.join(artifact_dir, n)) as bf:
                d = json.load(bf)
            frames.append({"frame": int(d.get(
                "frame", _BONES_RE.match(n).group(1))),
                "bones": d["bones"]})
        eid = "editor"
        body.append(
            f"<div class=panel><h2>annotation editor</h2>"
            f"<canvas id={eid} width=420 height=420></canvas>"
            f"<div><input type=range id={eid}-sl min=0 "
            f"max={len(frames) - 1} value=0 step=1> "
            f"<span class=lbl id={eid}-lab></span></div>"
            f"<div class=lbl>"
            f"<label><input type=radio name={eid}-mode value=orbit checked>"
            f" orbit</label> "
            f"<label><input type=radio name={eid}-mode value=drag>"
            f" drag bone</label> "
            f"<button id={eid}-hold1>hold 1</button> "
            f"<button id={eid}-hold2>hold 2</button> "
            f"<button id={eid}-del>delete frame</button> "
            f"<button id={eid}-clear>clear frame</button> "
            f"<a id={eid}-dl download=edits.json>download edits.json</a>"
            f"</div>"
            f"<textarea id={eid}-json rows=6 cols=52 class=lbl "
            f"spellcheck=false></textarea>"
            f"<div class=lbl>apply with: python -m "
            f"hand_tracking_samples_tpu_torch.apps.annotate REC.rs --edits "
            f"edits.json --out REC_fixed</div>"
            f"</div>")
        init.append(f"editview({json.dumps(eid)}, {json.dumps(frames)});")
    for i, (prefix, files) in enumerate(sorted(series.items())):
        sid = f"s{i}"
        title = _html.escape(prefix.rstrip("_-.") or "frames")
        body.append(
            f"<div class=panel><h2>{title}</h2>"
            f"<img class=frame id={sid}-img>"
            f"<div><button id={sid}-btn>play</button> "
            f"<input type=range id={sid}-sl min=0 max={len(files) - 1} "
            f"value=0 step=1> <span class=lbl id={sid}-lab></span></div>"
            f"</div>")
        init.append(f"scrub({json.dumps(sid)}, {json.dumps(files)});")
    for i, name in enumerate(objs):
        cid = f"o{i}"
        verts, edges = _parse_obj(os.path.join(artifact_dir, name))
        body.append(
            f"<div class=panel><h2>{_html.escape(name)}</h2>"
            f"<canvas id={cid} width=420 height=420></canvas></div>")
        init.append(f"objview({json.dumps(cid)}, {json.dumps(verts)}, "
                    f"{json.dumps(edges)});")
    if loose:
        body.append("<h2>images</h2>" + "".join(
            f"<div class=panel><div class=lbl>{_html.escape(n)}</div>"
            f'<img class=frame src="{_html.escape(n, quote=True)}"></div>'
            for n in loose))

    path = os.path.join(artifact_dir, out_name)
    with open(path, "w") as f:
        f.write(_PAGE.format(body="\n".join(body), init="\n".join(init)))
    return path


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Build an index.html viewer over an artifact directory")
    ap.add_argument("artifact_dir")
    args = ap.parse_args(argv)
    print(write_html_report(args.artifact_dir))


if __name__ == "__main__":
    main()
