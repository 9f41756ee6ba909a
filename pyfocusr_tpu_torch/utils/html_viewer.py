"""Self-contained HTML/WebGL viewer export.

A copy of ``pyfocusr_tpu/utils/html_viewer.py`` (numpy; the port imports
nothing of the JAX package): :func:`export_html` writes one ``.html`` file
(no network access, no external scripts, vanilla WebGL) that renders
triangle meshes and point clouds with per-vertex scalar coloring (viridis
and a colorbar), orbit / pan / zoom mouse controls and per-geometry
visibility toggles in any browser; the dependency-free counterpart of the
reference's itkwidgets viewers (``focusr.py:646-795``, ``graph.py:296-314``).
Every array may be a tensor on any device (``utils.device.to_numpy``).

Array payloads are embedded as base64 little-endian buffers
(``Float32Array`` / ``Uint32Array``) rather than JSON number lists: a
15k-vertex mesh is ~240 KB of positions instead of ~1 MB of text, and
decoding is a single ``atob`` pass.

Consumers: :meth:`pyfocusr_tpu_torch.Focusr.export_viewer_html`,
:meth:`pyfocusr_tpu_torch.Graph.export_viewer_html`, and direct use::

    from pyfocusr_tpu_torch.utils.html_viewer import export_html
    export_html("scene.html", meshes=[mesh], point_sets=[coords])
"""

from __future__ import annotations

import base64
import json
import os
from typing import Sequence

import numpy as np

from .device import to_numpy

__all__ = ["export_html"]


def _b64_f32(arr) -> str:
    a = np.ascontiguousarray(to_numpy(arr, "<f4"))
    return base64.b64encode(a.tobytes()).decode("ascii")


def _b64_u32(arr) -> str:
    a = np.ascontiguousarray(to_numpy(arr, "<u4"))
    return base64.b64encode(a.tobytes()).decode("ascii")


def _default_colors(n: int):
    from .viz import default_colors

    return default_colors(n)


def _mesh_entry(mesh, name: str, color) -> dict:
    pts = to_numpy(mesh.points, np.float32)
    tris = to_numpy(mesh.triangles, np.uint32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"mesh '{name}': points must be [N, 3], got {pts.shape}")
    if tris.ndim != 2 or tris.shape[1] != 3:
        raise ValueError(
            f"mesh '{name}': triangles must be [F, 3], got {tris.shape}"
        )
    scalars = {}
    for sname, vals in getattr(mesh, "point_data", {}).items():
        v = to_numpy(vals, np.float32).reshape(-1)
        if v.shape[0] != pts.shape[0]:
            continue  # not per-vertex (e.g. cell data); viewer shows vertices
        finite = v[np.isfinite(v)]
        lo = float(finite.min()) if finite.size else 0.0
        hi = float(finite.max()) if finite.size else 1.0
        scalars[str(sname)] = {"b64": _b64_f32(v), "min": lo, "max": hi}
    return {
        "name": name,
        "n": int(pts.shape[0]),
        "f": int(tris.shape[0]),
        "pos": _b64_f32(pts),
        "idx": _b64_u32(tris),
        "scalars": scalars,
        "color": [float(c) for c in color],
    }


def _point_set_entry(points, name: str, color) -> dict:
    pts = to_numpy(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(
            f"point set '{name}': need [N, >=3] coordinates, got {pts.shape}"
        )
    pts = pts[:, :3]
    return {
        "name": name,
        "n": int(pts.shape[0]),
        "pos": _b64_f32(pts),
        "color": [float(c) for c in color],
    }


def export_html(
    file_path: str,
    meshes: Sequence = (),
    mesh_names: Sequence[str] | None = None,
    point_sets: Sequence = (),
    point_set_names: Sequence[str] | None = None,
    colors: Sequence | None = None,
    title: str = "pyfocusr_tpu viewer",
    point_size: float = 4.0,
) -> str:
    """Write a standalone HTML viewer for ``meshes`` and ``point_sets``.

    meshes:      TriMesh-likes (``.points`` [N,3], ``.triangles`` [F,3],
                 optional ``.point_data`` dict of per-vertex scalars — each
                 becomes a selectable coloring with a viridis colorbar).
    point_sets:  [N,3] arrays rendered as GL points.
    colors:      optional RGB triples (0-1) for all geometries in order
                 (meshes first, then point sets); defaults to the reference
                 notebook's matplotlib cycle (``viz.default_colors``).
    Returns the absolute path written.
    """
    meshes = list(meshes)
    point_sets = list(point_sets)
    if not meshes and not point_sets:
        raise ValueError("export_html needs at least one mesh or point set")
    n_geo = len(meshes) + len(point_sets)
    if colors is None:
        colors = _default_colors(n_geo)
    if len(colors) < n_geo:
        colors = list(colors) + _default_colors(n_geo)[len(colors):]
    mesh_names = list(mesh_names or [])
    while len(mesh_names) < len(meshes):
        mesh_names.append(f"mesh {len(mesh_names)}")
    point_set_names = list(point_set_names or [])
    while len(point_set_names) < len(point_sets):
        point_set_names.append(f"points {len(point_set_names)}")

    data = {
        "title": str(title),
        "pointSize": float(point_size),
        "meshes": [
            _mesh_entry(m, mesh_names[i], colors[i]) for i, m in enumerate(meshes)
        ],
        "pointSets": [
            _point_set_entry(p, point_set_names[i], colors[len(meshes) + i])
            for i, p in enumerate(point_sets)
        ],
    }
    # </script> inside a JSON string would terminate the script block early.
    # Escape EVERY '<' (< round-trips identically through JSON): bare
    # '</' would close the script element, and '<!--' + '<script' in a
    # user-supplied name would put the parser into the double-escaped
    # script state and swallow the viewer code entirely.
    payload = json.dumps(data).replace("<", "\\u003c")
    # Substitute by splitting, not sequential .replace: a title containing
    # the literal '__DATA__' (or a scalar named '__TITLE__' in the payload)
    # must never be re-scanned by the other substitution.
    head, tail = _TEMPLATE.split("__DATA__")
    esc_title = _escape(title)
    html = (
        head.replace("__TITLE__", esc_title)
        + payload
        + tail.replace("__TITLE__", esc_title)
    )
    file_path = os.path.abspath(file_path)
    with open(file_path, "w", encoding="utf-8") as fh:
        fh.write(html)
    return file_path


def _escape(text: str) -> str:
    import html

    return html.escape(text, quote=False)


# The entire runtime: one HTML page, zero external references.  WebGL1 +
# OES_element_index_uint (universal) so it also runs under older embedded
# webviews.  Kept deliberately framework-free: matrix math, trackball and
# viridis are inlined below (~300 lines).
_TEMPLATE = r"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>__TITLE__</title>
<style>
  html, body { margin: 0; height: 100%; overflow: hidden; background: #1b1e23;
               font: 13px system-ui, sans-serif; color: #d8dbe0; }
  #gl { position: absolute; inset: 0; width: 100%; height: 100%; display: block; }
  #panel { position: absolute; top: 10px; left: 10px; background: rgba(24,27,32,.88);
           border: 1px solid #3a3f47; border-radius: 8px; padding: 10px 12px;
           max-width: 280px; max-height: calc(100% - 40px); overflow: auto; }
  #panel h1 { font-size: 13px; margin: 0 0 8px; font-weight: 600; }
  .geo { margin: 4px 0; display: flex; align-items: center; gap: 6px; flex-wrap: wrap; }
  .swatch { width: 10px; height: 10px; border-radius: 2px; display: inline-block; }
  select { background: #262a31; color: inherit; border: 1px solid #3a3f47;
           border-radius: 4px; font: inherit; max-width: 120px; }
  #colorbar { position: absolute; right: 16px; bottom: 16px; background: rgba(24,27,32,.88);
              border: 1px solid #3a3f47; border-radius: 8px; padding: 8px 10px;
              display: none; text-align: center; }
  #colorbar canvas { display: block; margin: 4px auto; }
  #hint { position: absolute; right: 16px; top: 12px; color: #8b919b; }
</style>
</head>
<body>
<canvas id="gl"></canvas>
<div id="panel"><h1>__TITLE__</h1><div id="geos"></div></div>
<div id="colorbar"><div id="cbname"></div><canvas width="18" height="128"></canvas>
  <div id="cbmax"></div><div style="color:#8b919b">&#8942;</div><div id="cbmin"></div></div>
<div id="hint">drag: rotate &middot; wheel: zoom &middot; shift-drag: pan</div>
<script id="scene" type="application/json">__DATA__</script>
<script>
"use strict";
const DATA = JSON.parse(document.getElementById("scene").textContent);

function decode(b64, Ctor) {
  const s = atob(b64), buf = new ArrayBuffer(s.length), view = new Uint8Array(buf);
  for (let i = 0; i < s.length; i++) view[i] = s.charCodeAt(i);
  return new Ctor(buf);
}

/* ---- minimal mat4 (column-major, WebGL convention) ---- */
function perspective(fovy, aspect, near, far) {
  const f = 1 / Math.tan(fovy / 2), nf = 1 / (near - far);
  return [f / aspect,0,0,0, 0,f,0,0, 0,0,(far+near)*nf,-1, 0,0,2*far*near*nf,0];
}
function mul4(a, b) {
  const o = new Array(16);
  for (let c = 0; c < 4; c++) for (let r = 0; r < 4; r++) {
    o[c*4+r] = a[r]*b[c*4] + a[4+r]*b[c*4+1] + a[8+r]*b[c*4+2] + a[12+r]*b[c*4+3];
  }
  return o;
}
function lookAt(eye, center, up) {
  let z = [eye[0]-center[0], eye[1]-center[1], eye[2]-center[2]];
  const zl = Math.hypot(...z); z = z.map(v => v / zl);
  let x = [up[1]*z[2]-up[2]*z[1], up[2]*z[0]-up[0]*z[2], up[0]*z[1]-up[1]*z[0]];
  const xl = Math.hypot(...x) || 1; x = x.map(v => v / xl);
  const y = [z[1]*x[2]-z[2]*x[1], z[2]*x[0]-z[0]*x[2], z[0]*x[1]-z[1]*x[0]];
  return [x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
          -(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]),
          -(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]),
          -(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]), 1];
}

/* ---- viridis ---- */
const VIRIDIS = [[0.267,0.005,0.329],[0.283,0.141,0.458],[0.254,0.265,0.530],
  [0.207,0.372,0.553],[0.164,0.471,0.558],[0.128,0.567,0.551],
  [0.135,0.659,0.518],[0.267,0.749,0.441],[0.478,0.821,0.318],
  [0.741,0.873,0.150],[0.993,0.906,0.144]];
function viridis(t) {
  t = Math.min(1, Math.max(0, t));
  const x = t * (VIRIDIS.length - 1), i = Math.min(VIRIDIS.length - 2, Math.floor(x)),
        f = x - i, a = VIRIDIS[i], b = VIRIDIS[i + 1];
  return [a[0]+(b[0]-a[0])*f, a[1]+(b[1]-a[1])*f, a[2]+(b[2]-a[2])*f];
}

/* ---- GL setup ---- */
const canvas = document.getElementById("gl");
const gl = canvas.getContext("webgl", { antialias: true });
if (!gl) { document.body.innerHTML = "<p style='padding:2em'>WebGL unavailable</p>"; throw 0; }
gl.getExtension("OES_element_index_uint");

function program(vsrc, fsrc) {
  function sh(type, src) {
    const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
    if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
      throw new Error(gl.getShaderInfoLog(s));
    return s;
  }
  const p = gl.createProgram();
  gl.attachShader(p, sh(gl.VERTEX_SHADER, vsrc));
  gl.attachShader(p, sh(gl.FRAGMENT_SHADER, fsrc));
  gl.linkProgram(p);
  if (!gl.getProgramParameter(p, gl.LINK_STATUS))
    throw new Error(gl.getProgramInfoLog(p));
  return p;
}

const meshProg = program(
  `attribute vec3 aPos; attribute vec3 aNrm; attribute vec3 aCol;
   uniform mat4 uMVP; uniform mat4 uView;
   varying vec3 vCol; varying vec3 vNrm;
   void main() {
     gl_Position = uMVP * vec4(aPos, 1.0);
     vNrm = mat3(uView[0].xyz, uView[1].xyz, uView[2].xyz) * aNrm;
     vCol = aCol;
   }`,
  `precision mediump float; varying vec3 vCol; varying vec3 vNrm;
   void main() {
     float d = abs(normalize(vNrm).z);           /* headlight, two-sided */
     vec3 c = vCol * (0.30 + 0.70 * d) + vec3(0.08) * pow(d, 24.0);
     gl_FragColor = vec4(c, 1.0);
   }`);

const ptProg = program(
  `attribute vec3 aPos; uniform mat4 uMVP; uniform float uSize;
   void main() { gl_Position = uMVP * vec4(aPos, 1.0); gl_PointSize = uSize; }`,
  `precision mediump float; uniform vec3 uCol;
   void main() {
     vec2 d = gl_PointCoord - vec2(0.5);
     if (dot(d, d) > 0.25) discard;              /* round sprite */
     gl_FragColor = vec4(uCol, 1.0);
   }`);

/* ---- geometry upload ---- */
function vertexNormals(pos, idx, n) {
  const nrm = new Float32Array(n * 3);
  for (let t = 0; t < idx.length; t += 3) {
    const a = idx[t] * 3, b = idx[t+1] * 3, c = idx[t+2] * 3;
    const ux = pos[b]-pos[a], uy = pos[b+1]-pos[a+1], uz = pos[b+2]-pos[a+2];
    const vx = pos[c]-pos[a], vy = pos[c+1]-pos[a+1], vz = pos[c+2]-pos[a+2];
    const nx = uy*vz-uz*vy, ny = uz*vx-ux*vz, nz = ux*vy-uy*vx;
    for (const k of [a, b, c]) { nrm[k] += nx; nrm[k+1] += ny; nrm[k+2] += nz; }
  }
  for (let i = 0; i < n; i++) {
    const l = Math.hypot(nrm[i*3], nrm[i*3+1], nrm[i*3+2]) || 1;
    nrm[i*3] /= l; nrm[i*3+1] /= l; nrm[i*3+2] /= l;
  }
  return nrm;
}

function buf(target, data) {
  const b = gl.createBuffer(); gl.bindBuffer(target, b);
  gl.bufferData(target, data, gl.STATIC_DRAW); return b;
}

const geos = [];
let lo = [Infinity, Infinity, Infinity], hi = [-Infinity, -Infinity, -Infinity];
function extend(pos) {
  for (let i = 0; i < pos.length; i += 3) for (let k = 0; k < 3; k++) {
    if (pos[i+k] < lo[k]) lo[k] = pos[i+k];
    if (pos[i+k] > hi[k]) hi[k] = pos[i+k];
  }
}

for (const m of DATA.meshes) {
  const pos = decode(m.pos, Float32Array), idx = decode(m.idx, Uint32Array);
  extend(pos);
  const colors = new Float32Array(m.n * 3);
  const g = {
    kind: "mesh", name: m.name, visible: true, n: m.n, nIdx: idx.length,
    pos, color: m.color, scalars: m.scalars, scalarName: null,
    vbPos: buf(gl.ARRAY_BUFFER, pos),
    vbNrm: buf(gl.ARRAY_BUFFER, vertexNormals(pos, idx, m.n)),
    vbCol: buf(gl.ARRAY_BUFFER, colors),
    ib: buf(gl.ELEMENT_ARRAY_BUFFER, idx),
    colorArr: colors,
  };
  geos.push(g);  // before setMeshColor: updateColorbar scans geos
  const names = Object.keys(m.scalars);
  setMeshColor(g, names.length ? names[0] : null);
}
for (const p of DATA.pointSets) {
  const pos = decode(p.pos, Float32Array);
  extend(pos);
  geos.push({ kind: "points", name: p.name, visible: true, n: p.n,
              color: p.color, vbPos: buf(gl.ARRAY_BUFFER, pos) });
}

function setMeshColor(g, scalarName) {
  g.scalarName = scalarName;
  const c = g.colorArr;
  if (scalarName && g.scalars[scalarName]) {
    const s = g.scalars[scalarName];
    if (!s.values) s.values = decode(s.b64, Float32Array);
    const span = (s.max - s.min) || 1;
    for (let i = 0; i < g.n; i++) {
      const t = (s.values[i] - s.min) / span;
      // Non-finite samples (NaN thickness etc.) render neutral gray
      // instead of crashing the indexed colormap lookup.
      const rgb = isFinite(t) ? viridis(t) : [0.55, 0.55, 0.55];
      c[i*3] = rgb[0]; c[i*3+1] = rgb[1]; c[i*3+2] = rgb[2];
    }
  } else {
    for (let i = 0; i < g.n; i++) {
      c[i*3] = g.color[0]; c[i*3+1] = g.color[1]; c[i*3+2] = g.color[2];
    }
  }
  gl.bindBuffer(gl.ARRAY_BUFFER, g.vbCol);
  gl.bufferData(gl.ARRAY_BUFFER, c, gl.STATIC_DRAW);
  updateColorbar();
}

function updateColorbar() {
  // Single source of truth: show the FIRST visible mesh that is colored by
  // a scalar; hide the bar when no rendered coloring uses one.
  const cb = document.getElementById("colorbar");
  const g = geos.find(
    g => g.kind === "mesh" && g.visible && g.scalarName
  );
  if (!g) { cb.style.display = "none"; return; }
  const s = g.scalars[g.scalarName];
  cb.style.display = "block";
  document.getElementById("cbname").textContent = g.name + " · " + g.scalarName;
  document.getElementById("cbmin").textContent = s.min.toPrecision(4);
  document.getElementById("cbmax").textContent = s.max.toPrecision(4);
  const cv = cb.querySelector("canvas"), ctx = cv.getContext("2d");
  for (let y = 0; y < cv.height; y++) {
    const rgb = viridis(1 - y / (cv.height - 1));
    ctx.fillStyle = `rgb(${rgb.map(v => Math.round(v*255)).join(",")})`;
    ctx.fillRect(0, y, cv.width, 1);
  }
}

/* ---- UI panel ---- */
const panel = document.getElementById("geos");
for (const g of geos) {
  const row = document.createElement("div"); row.className = "geo";
  const cb = document.createElement("input"); cb.type = "checkbox"; cb.checked = true;
  cb.onchange = () => { g.visible = cb.checked; updateColorbar(); draw(); };
  const sw = document.createElement("span"); sw.className = "swatch";
  sw.style.background = `rgb(${g.color.map(v => Math.round(v*255)).join(",")})`;
  const lab = document.createElement("span");
  lab.textContent = `${g.name} (${g.n.toLocaleString()} pts)`;
  row.append(cb, sw, lab);
  if (g.kind === "mesh" && Object.keys(g.scalars).length) {
    const sel = document.createElement("select");
    const solid = document.createElement("option");
    solid.value = ""; solid.textContent = "solid";
    sel.append(solid);
    for (const name of Object.keys(g.scalars)) {
      const o = document.createElement("option");
      o.value = name; o.textContent = name; sel.append(o);
    }
    sel.value = g.scalarName || "";
    sel.onchange = () => { setMeshColor(g, sel.value || null); draw(); };
    row.append(sel);
  }
  panel.append(row);
}

/* ---- camera ---- */
const center = [(lo[0]+hi[0])/2, (lo[1]+hi[1])/2, (lo[2]+hi[2])/2];
const radius = Math.max(1e-6, Math.hypot(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2]) / 2);
const cam = { theta: 0.5, phi: 0.9, dist: radius * 2.8, target: center.slice() };

function viewMatrix() {
  const ct = Math.cos(cam.theta), st = Math.sin(cam.theta);
  const cp = Math.cos(cam.phi), sp = Math.sin(cam.phi);
  const eye = [cam.target[0] + cam.dist * sp * ct,
               cam.target[1] + cam.dist * cp,
               cam.target[2] + cam.dist * sp * st];
  return lookAt(eye, cam.target, [0, 1, 0]);
}

let drag = null;
canvas.addEventListener("mousedown", e => {
  drag = { x: e.clientX, y: e.clientY, pan: e.shiftKey || e.button === 2 };
});
window.addEventListener("mouseup", () => { drag = null; });
window.addEventListener("mousemove", e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) {
    const v = viewMatrix(), s = cam.dist * 0.0016;
    cam.target[0] -= (v[0]*dx - v[1]*dy) * s;
    cam.target[1] -= (v[4]*dx - v[5]*dy) * s;
    cam.target[2] -= (v[8]*dx - v[9]*dy) * s;
  } else {
    cam.theta += dx * 0.008;
    cam.phi = Math.min(Math.PI - 0.02, Math.max(0.02, cam.phi - dy * 0.008));
  }
  draw();
});
canvas.addEventListener("wheel", e => {
  e.preventDefault();
  cam.dist *= Math.exp(e.deltaY * 0.0012);
  cam.dist = Math.min(radius * 40, Math.max(radius * 0.05, cam.dist));
  draw();
}, { passive: false });
canvas.addEventListener("contextmenu", e => e.preventDefault());

/* ---- render ---- */
function draw() {
  const dpr = window.devicePixelRatio || 1;
  // Round BEFORE comparing: canvas.width truncates to an integer, so a
  // fractional DPR (125% displays) would mismatch every frame and
  // reallocate+clear the drawing buffer on each redraw.
  const w = Math.round(canvas.clientWidth * dpr), h = Math.round(canvas.clientHeight * dpr);
  if (canvas.width !== w || canvas.height !== h) { canvas.width = w; canvas.height = h; }
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.106, 0.118, 0.137, 1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const view = viewMatrix();
  const proj = perspective(0.8, w / h, radius * 0.01, radius * 100);
  const mvp = mul4(proj, view);

  gl.useProgram(meshProg);
  gl.uniformMatrix4fv(gl.getUniformLocation(meshProg, "uMVP"), false, mvp);
  gl.uniformMatrix4fv(gl.getUniformLocation(meshProg, "uView"), false, view);
  for (const g of geos) {
    if (g.kind !== "mesh" || !g.visible) continue;
    for (const [attr, vb] of [["aPos", g.vbPos], ["aNrm", g.vbNrm], ["aCol", g.vbCol]]) {
      const loc = gl.getAttribLocation(meshProg, attr);
      gl.bindBuffer(gl.ARRAY_BUFFER, vb);
      gl.enableVertexAttribArray(loc);
      gl.vertexAttribPointer(loc, 3, gl.FLOAT, false, 0, 0);
    }
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, g.ib);
    gl.drawElements(gl.TRIANGLES, g.nIdx, gl.UNSIGNED_INT, 0);
  }

  gl.useProgram(ptProg);
  gl.uniformMatrix4fv(gl.getUniformLocation(ptProg, "uMVP"), false, mvp);
  gl.uniform1f(gl.getUniformLocation(ptProg, "uSize"),
               DATA.pointSize * dpr);
  for (const g of geos) {
    if (g.kind !== "points" || !g.visible) continue;
    gl.uniform3fv(gl.getUniformLocation(ptProg, "uCol"), g.color);
    const loc = gl.getAttribLocation(ptProg, "aPos");
    gl.bindBuffer(gl.ARRAY_BUFFER, g.vbPos);
    gl.enableVertexAttribArray(loc);
    gl.vertexAttribPointer(loc, 3, gl.FLOAT, false, 0, 0);
    gl.drawArrays(gl.POINTS, 0, g.n);
  }
  window.__pyfocusrDrawn = (window.__pyfocusrDrawn || 0) + 1;
}

window.addEventListener("resize", draw);
draw();
</script>
</body>
</html>
"""
