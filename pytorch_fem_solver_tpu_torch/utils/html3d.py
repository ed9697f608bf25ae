"""Self-contained interactive 3D export for fracture-network solutions.

Counterpart of ``pytorch_fem_solver_tpu/utils/html3d.py``: one
self-contained ``.html`` file (raw inline WebGL, no CDN or network
dependency) with orbit/zoom/pan controls, per-vertex or flat per-cell
viridis coloring, a colorbar and trace-segment overlays. Meshes are read
through host copies of their tables and values may be tensors on any
device; the embedded data equal the JAX package's for the same mesh and
values.

Typical use::

    from pytorch_fem_solver_tpu_torch.utils.html3d import export_network_html
    export_network_html(mesh, "solution.html", vertex_values=u[:, 0])
    export_network_html(mesh, "error.html", cell_values=rel_err,
                        title="per-element relative H1 error")

Works with any mesh exposing ``mesh["vertices", "coordinates_3d"]`` (or
planar ``coordinates``, lifted with z = 0) and ``mesh["cells",
"vertices"]``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..basis.abstract_basis import host

__all__ = ["export_network_html", "viridis_rgb"]

# 16-stop piecewise-linear viridis (matplotlib's table, subsampled) — keeps
# the export matplotlib-free at render time
_VIRIDIS = np.array(
    [
        (0.267004, 0.004874, 0.329415),
        (0.282623, 0.140926, 0.457517),
        (0.253935, 0.265254, 0.529983),
        (0.206756, 0.371758, 0.553117),
        (0.163625, 0.471133, 0.558148),
        (0.127568, 0.566949, 0.550556),
        (0.134692, 0.658636, 0.517649),
        (0.266941, 0.748751, 0.440573),
        (0.477504, 0.821444, 0.318195),
        (0.741388, 0.873449, 0.149561),
        (0.993248, 0.906157, 0.143936),
    ]
)


def viridis_rgb(t: np.ndarray) -> np.ndarray:
    """(n,) values in [0, 1] -> (n, 3) viridis RGB in [0, 1]."""
    t = np.clip(host(t).astype(np.float64), 0.0, 1.0)
    x = t * (len(_VIRIDIS) - 1)
    i = np.minimum(x.astype(np.int64), len(_VIRIDIS) - 2)
    w = (x - i)[:, None]
    return _VIRIDIS[i] * (1 - w) + _VIRIDIS[i + 1] * w


def _mesh_geometry(mesh):
    """(verts (n,3) f64, tris (T,3) i64) in the numbering ``cells``
    indexes: the flat per-fracture stacking for DFN meshes (their
    ``global`` group uses the glued numbering instead — see
    ``_to_flat_values`` for the mapping), plain vertices otherwise."""
    try:
        verts = host(mesh["vertices", "coordinates_3d"]).astype(np.float64)
    except Exception:
        verts = host(mesh["vertices", "coordinates"]).astype(np.float64)
        if verts.shape[1] == 2:  # planar mesh: lift with z = 0
            verts = np.concatenate(
                [verts, np.zeros((verts.shape[0], 1))], axis=1
            )
    tris = host(mesh["cells", "vertices"]).astype(np.int64)
    tris = tris.reshape(-1, tris.shape[-1])
    return verts, tris


def _to_flat_values(mesh, vals, n_flat):
    """Accept nodal values in either the flat numbering (n_flat) or the
    DFN's glued global numbering (gathered onto the flat vertices)."""
    if vals.shape[0] == n_flat:
        return vals
    try:
        gid = host(mesh["global", "ids"]).astype(np.int64).reshape(-1)
    except Exception:
        gid = None
    if gid is not None and vals.shape[0] == int(gid.max()) + 1:
        return vals[gid]
    raise ValueError(
        f"vertex_values has {vals.shape[0]} entries for {n_flat} vertices"
    )


def _trace_segments(mesh, verts):
    """(S, 2, 3) trace segments (DFN) or marked-edge segments (planar);
    empty when the mesh exposes neither."""
    try:  # DFN: interior edges shared between fractures
        ie = host(mesh["interior_edges", "vertices"]).astype(np.int64)
        mask = host(mesh["interior_edges", "trace_mask"]).reshape(-1) > 0
        if mask.any():
            return verts[ie[mask]]
    except Exception:
        pass
    try:
        edges = host(mesh["edges", "vertices"]).astype(np.int64)
        markers = host(mesh["edges", "markers"]).reshape(-1)
    except Exception:
        return np.zeros((0, 2, 3))
    keep = markers > 0
    if edges.size and int(edges.max()) < verts.shape[0] and keep.any():
        return verts[edges[keep]]
    return np.zeros((0, 2, 3))


def export_network_html(
    mesh,
    path: str,
    vertex_values: Optional[np.ndarray] = None,
    cell_values: Optional[np.ndarray] = None,
    title: str = "fracture network",
    show_traces: bool = True,
    clim: Optional[tuple] = None,
    decimals: int = 5,
) -> str:
    """Write a standalone interactive WebGL viewer for a mesh + field.

    Exactly one of ``vertex_values`` (smooth per-vertex coloring, e.g. the
    solution) or ``cell_values`` (flat per-cell coloring, e.g. an error
    map) may be given; with neither, fractures get constant colors.
    Returns ``path``.
    """
    if vertex_values is not None and cell_values is not None:
        raise ValueError("pass vertex_values OR cell_values, not both")
    verts, tris = _mesh_geometry(mesh)

    def flat_cells(rgb_cell):
        """Flat shading: split shared vertices so each triangle carries
        its own constant color."""
        pos = verts[tris.reshape(-1)]
        col = np.repeat(rgb_cell, 3, axis=0)
        idx = np.arange(pos.shape[0], dtype=np.int64).reshape(-1, 3)
        return pos, col, idx

    if cell_values is not None:
        vals = host(cell_values).astype(np.float64).reshape(-1)
        if vals.shape[0] != tris.shape[0]:
            raise ValueError(
                f"cell_values has {vals.shape[0]} entries for "
                f"{tris.shape[0]} cells"
            )
        lo, hi = clim if clim is not None else (vals.min(), vals.max())
        pos, col, idx = flat_cells(
            viridis_rgb((vals - lo) / max(hi - lo, 1e-300))
        )
    elif vertex_values is not None:
        vals = _to_flat_values(
            mesh,
            host(vertex_values).astype(np.float64).reshape(-1),
            verts.shape[0],
        )
        lo, hi = clim if clim is not None else (vals.min(), vals.max())
        col = viridis_rgb((vals - lo) / max(hi - lo, 1e-300))
        pos, idx = verts, tris
    else:
        lo = hi = 0.0
        try:  # geometry-only view: one constant color per fracture
            frac = host(mesh["cells", "fracture"]).reshape(-1)
            nf = max(int(frac.max()) + 1, 1)
            pos, col, idx = flat_cells(
                viridis_rgb((np.arange(nf) + 0.5) / nf)[frac]
            )
        except Exception:
            col = np.full((verts.shape[0], 3), 0.6)
            pos, idx = verts, tris

    segs = _trace_segments(mesh, verts) if show_traces else np.zeros((0, 2, 3))

    center = 0.5 * (pos.min(0) + pos.max(0))
    radius = float(np.linalg.norm(pos.max(0) - pos.min(0)) / 2) or 1.0

    def flat(a):
        return np.round(np.asarray(a, dtype=np.float64), decimals).reshape(
            -1
        ).tolist()

    data = {
        "positions": flat(pos - center),
        "colors": flat(col),
        "indices": np.asarray(idx, dtype=np.int64).reshape(-1).tolist(),
        "lines": flat(segs - center if segs.size else segs),
        "radius": radius,
        "vmin": float(lo),
        "vmax": float(hi),
        "title": title,
        "n_cells": int(tris.shape[0]),
        "n_verts": int(verts.shape[0]),
    }
    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(html)
    return path


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>fem viewer</title><style>
 html,body{margin:0;height:100%;overflow:hidden;background:#111;font-family:sans-serif}
 #c{width:100%;height:100%;display:block}
 #hud{position:absolute;top:10px;left:10px;color:#ddd;font-size:13px}
 #bar{position:absolute;right:18px;top:10%;height:60%;width:14px;border:1px solid #888;
   background:linear-gradient(to top,#440154,#46327e,#365c8d,#277f8e,#1fa187,#4ac16d,#a0da39,#fde725)}
 .tick{position:absolute;right:40px;color:#ddd;font-size:12px;transform:translateY(-50%)}
</style></head><body>
<canvas id="c"></canvas><div id="hud"></div><div id="bar"></div>
<script>
const D=__DATA__;
const canvas=document.getElementById('c');
const gl=canvas.getContext('webgl',{antialias:true});
gl.getExtension('OES_element_index_uint');
const vsrc=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;varying vec3 vc;
 void main(){gl_Position=mvp*vec4(p,1.0);vc=col;}`;
const fsrc=`precision mediump float;varying vec3 vc;uniform float solid;
 uniform vec3 solidCol;void main(){gl_FragColor=vec4(mix(vc,solidCol,solid),1.0);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);gl.compileShader(o);return o;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,vsrc));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,fsrc));
gl.linkProgram(prog);gl.useProgram(prog);
const locP=gl.getAttribLocation(prog,'p'),locC=gl.getAttribLocation(prog,'col');
const locM=gl.getUniformLocation(prog,'mvp'),locS=gl.getUniformLocation(prog,'solid'),
      locSC=gl.getUniformLocation(prog,'solidCol');
function buf(t,a){const b=gl.createBuffer();gl.bindBuffer(t,b);gl.bufferData(t,a,gl.STATIC_DRAW);return b;}
const pb=buf(gl.ARRAY_BUFFER,new Float32Array(D.positions));
const cb=buf(gl.ARRAY_BUFFER,new Float32Array(D.colors));
const ib=buf(gl.ELEMENT_ARRAY_BUFFER,new Uint32Array(D.indices));
const lb=buf(gl.ARRAY_BUFFER,new Float32Array(D.lines));
const nIdx=D.indices.length,nLine=D.lines.length/3;
let yaw=0.6,pitch=0.4,dist=D.radius*2.6,panX=0,panY=0;
function mat(){
 const a=canvas.width/canvas.height,f=1/Math.tan(0.4),n=D.radius*0.01,fa=D.radius*40;
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 // rotate then translate back by dist, then project
 const r=[cy,sy*sp,-sy*cp,0, 0,cp,sp,0, sy,-cy*sp,cy*cp,0, panX,panY,-dist,1];
 const p=[f/a,0,0,0, 0,f,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0];
 const m=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;for(let k=0;k<4;k++)s+=r[i*4+k]*p[k*4+j];m[i*4+j]=s;}
 return m;}
function draw(){
 canvas.width=innerWidth*devicePixelRatio;canvas.height=innerHeight*devicePixelRatio;
 gl.viewport(0,0,canvas.width,canvas.height);
 gl.enable(gl.DEPTH_TEST);gl.clearColor(0.066,0.066,0.066,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.uniformMatrix4fv(locM,false,mat());
 gl.bindBuffer(gl.ARRAY_BUFFER,pb);gl.enableVertexAttribArray(locP);
 gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,cb);gl.enableVertexAttribArray(locC);
 gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
 gl.uniform1f(locS,0.0);
 gl.enable(gl.POLYGON_OFFSET_FILL);gl.polygonOffset(1.0,1.0);
 gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ib);
 gl.drawElements(gl.TRIANGLES,nIdx,gl.UNSIGNED_INT,0);
 gl.disable(gl.POLYGON_OFFSET_FILL);
 if(nLine){
  gl.bindBuffer(gl.ARRAY_BUFFER,lb);
  gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
  // the color attribute must not read past the (smaller) triangle color
  // buffer during the line draw: give it a constant instead
  gl.disableVertexAttribArray(locC);gl.vertexAttrib3f(locC,0,0,0);
  gl.uniform1f(locS,1.0);gl.uniform3f(locSC,0.05,0.05,0.05);
  gl.drawArrays(gl.LINES,0,nLine);}
}
let drag=null;
canvas.addEventListener('mousedown',e=>{drag={x:e.clientX,y:e.clientY,b:e.button,sx:panX,sy:panY,yaw:yaw,pitch:pitch};});
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=(e.clientX-drag.x)/200,dy=(e.clientY-drag.y)/200;
 if(drag.b===2||e.shiftKey){panX=drag.sx+dx*D.radius;panY=drag.sy-dy*D.radius;}
 else{yaw=drag.yaw+dx;pitch=Math.max(-1.55,Math.min(1.55,drag.pitch+dy));}
 draw();});
canvas.addEventListener('wheel',e=>{e.preventDefault();dist*=Math.exp(e.deltaY*0.001);draw();});
canvas.addEventListener('contextmenu',e=>e.preventDefault());
addEventListener('resize',draw);
document.getElementById('hud').innerHTML=
 `<b>${D.title}</b><br>${D.n_cells.toLocaleString()} cells / ${D.n_verts.toLocaleString()} vertices`+
 `<br><span style="color:#999">drag: rotate &nbsp; shift/right-drag: pan &nbsp; wheel: zoom</span>`;
if(D.vmax>D.vmin){
 for(const[t,top]of[[D.vmax,'10%'],[0.5*(D.vmin+D.vmax),'40%'],[D.vmin,'70%']]){
  const el=document.createElement('div');el.className='tick';
  el.style.top=top;el.textContent=t.toExponential(2);
  document.body.appendChild(el);}}
else document.getElementById('bar').style.display='none';
draw();
</script></body></html>
"""
