"""[Copy of audiorenderingv2_tpu/utils/webview.py: numpy only, kept equal to it by tests/test_torch_utils.py.]

Interactive 3-D scene walkthrough as a single self-contained HTML file.

The reference ships a live OpenGL debug view — a GLFW window with a WASD +
mouse first-person camera over the scene mesh, receiver locked to the camera
(main.cpp:720-778 render loop; Camera.cpp WASD/cursor handling; Mesh.cpp +
assets/shaders for the draw). TPU pods are headless, so the TPU-native
equivalent is an exported browser artifact: :func:`write_walkthrough_html`
embeds the scene geometry (base64 float32), a pure-canvas software renderer
(painter's algorithm, flat shading — no external JS, works offline), and the
same control scheme:

  * WASD / RF: move (R up, F down), mouse drag: look (yaw/pitch)
  * the receiver rides the camera exactly like the reference locks its
    receiver to the camera pose (main.cpp:470-498)
  * ``T`` toggles trajectory recording (samples time/pos/yaw), ``E``
    downloads it as JSON in the exact shape
    :meth:`streaming.ListenerTrajectory.from_arrays` consumes — walk the
    scene in a browser, then auralize the walk offline with
    :class:`streaming.Auralizer`.

An optional auralized WAV (base64) embeds as an <audio> player so a scene
exported together with :func:`context.export_audio` output is a complete
"what does this room sound like from here" artifact.
"""
from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#101418;color:#cfd8e3;font:13px monospace;overflow:hidden}
 #hud{position:fixed;left:10px;top:10px;background:rgba(10,14,20,.75);
      padding:8px 12px;border-radius:6px;white-space:pre;pointer-events:none}
 #help{position:fixed;right:10px;top:10px;background:rgba(10,14,20,.75);
      padding:8px 12px;border-radius:6px;white-space:pre}
 #audio{position:fixed;left:10px;bottom:10px}
 canvas{display:block;cursor:grab}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="help">drag: look   WASD: move   R/F: up/down
T: record trajectory   E: export JSON</div>
__AUDIO__
<script>
"use strict";
const DATA = __DATA__;
function decodeF32(b64){
  const s = atob(b64); const a = new Uint8Array(s.length);
  for (let i=0;i<s.length;i++) a[i]=s.charCodeAt(i);
  return new Float32Array(a.buffer);
}
const V = decodeF32(DATA.tris);          // 9 floats per tri (v0 v1 v2)
const NT = V.length/9;
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
let W,H; function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
addEventListener("resize",resize); resize();

// camera state: position + yaw/pitch. The INTERNAL camera yaw w faces
// (sin w, 0, -cos w); the PACKAGE receiver yaw p faces (cos p, 0, sin p)
// (cli.py orbit / tracer ear split), so w = p + 90 deg at the data
// boundary — both on seed and on recorder export below.
let pos = DATA.receiver ? DATA.receiver.slice() : [0,1.6,4];
let yaw = DATA.yaw_deg*Math.PI/180 + Math.PI/2, pitch = 0;
const keys = {};
addEventListener("keydown",e=>{keys[e.key.toLowerCase()]=true; hot(e);});
addEventListener("keyup",e=>{keys[e.key.toLowerCase()]=false;});
let drag=null;
cv.addEventListener("mousedown",e=>{drag=[e.clientX,e.clientY];});
addEventListener("mouseup",()=>{drag=null;});
addEventListener("mousemove",e=>{
  if(!drag) return;
  yaw   += (e.clientX-drag[0])*0.004;
  pitch += (e.clientY-drag[1])*0.004;
  pitch = Math.max(-1.5,Math.min(1.5,pitch));
  drag=[e.clientX,e.clientY];
});

// trajectory recorder -> streaming.ListenerTrajectory.from_arrays shape
let rec=null;
function hot(e){
  const k=e.key.toLowerCase();
  if(k==="t"){
    if(rec){rec.active=!rec.active;}
    else rec={t0:performance.now()/1000,times:[],positions:[],yaws_deg:[],active:true};
  }
  if(k==="e"&&rec){
    const blob=new Blob([JSON.stringify({times:rec.times,
      positions:rec.positions,yaws_deg:rec.yaws_deg},null,1)],
      {type:"application/json"});
    const a=document.createElement("a");
    a.href=URL.createObjectURL(blob);a.download="trajectory.json";a.click();
  }
}

const zsort = new Array(NT); for(let i=0;i<NT;i++) zsort[i]={i:i,z:0};
function frame(dt){
  // move in the horizontal plane like the reference camera
  const s = (keys["shift"]?8:3)*dt;
  const fx=Math.sin(yaw), fz=-Math.cos(yaw);
  if(keys["w"]){pos[0]+=fx*s;pos[2]+=fz*s;}
  if(keys["s"]){pos[0]-=fx*s;pos[2]-=fz*s;}
  if(keys["a"]){pos[0]+=fz*s;pos[2]-=fx*s;}
  if(keys["d"]){pos[0]-=fz*s;pos[2]+=fx*s;}
  if(keys["r"])pos[1]+=s; if(keys["f"])pos[1]-=s;
  if(rec&&rec.active){
    const t=performance.now()/1000-rec.t0;
    if(!rec.times.length||t-rec.times[rec.times.length-1]>0.1){
      rec.times.push(+t.toFixed(3));
      rec.positions.push([+pos[0].toFixed(3),+pos[1].toFixed(3),+pos[2].toFixed(3)]);
      rec.yaws_deg.push(+(yaw*180/Math.PI-90).toFixed(2));
    }
  }

  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  const f=0.9*Math.min(W,H);
  ctx.fillStyle="#101418";ctx.fillRect(0,0,W,H);
  // view transform: translate, yaw about y, pitch about x
  function view(x,y,z){
    x-=pos[0];y-=pos[1];z-=pos[2];
    let vx= cy*x+sy*z, vz=-sy*x+cy*z, vy=y;
    let wy= cp*vy+sp*vz, wz=-sp*vy+cp*vz;
    return [vx,wy,-wz];   // +z into the screen
  }
  const P=new Float32Array(NT*9); let n=0;
  for(let i=0;i<NT;i++){
    let zc=0, out=0;
    for(let k=0;k<3;k++){
      const p=view(V[i*9+k*3],V[i*9+k*3+1],V[i*9+k*3+2]);
      P[i*9+k*3]=p[0];P[i*9+k*3+1]=p[1];P[i*9+k*3+2]=p[2];
      zc+=p[2]; if(p[2]<0.05)out++;
    }
    zsort[i].i=i; zsort[i].z=(out===3)?-1:zc/3;
  }
  zsort.sort((a,b)=>b.z-a.z);
  for(const e of zsort){
    if(e.z<0) continue;
    const i=e.i, q=[];
    for(let k=0;k<3;k++){
      const x=P[i*9+k*3],y=P[i*9+k*3+1],z=Math.max(P[i*9+k*3+2],0.05);
      q.push([W/2+f*x/z,H/2-f*y/z]);
    }
    // flat shade by view-space normal
    const ax=P[i*9+3]-P[i*9],ay=P[i*9+4]-P[i*9+1],az=P[i*9+5]-P[i*9+2];
    const bx=P[i*9+6]-P[i*9],by=P[i*9+7]-P[i*9+1],bz=P[i*9+8]-P[i*9+2];
    let nx=ay*bz-az*by,ny=az*bx-ax*bz,nz=ax*by-ay*bx;
    const nn=Math.hypot(nx,ny,nz)||1;
    const l=Math.abs((0.3*nx+0.5*ny+0.81*nz)/nn);
    const c=Math.round(60+130*l);
    ctx.fillStyle=`rgba(${c*0.55|0},${c*0.72|0},${c},0.92)`;
    ctx.strokeStyle="rgba(20,28,38,0.8)";
    ctx.beginPath();ctx.moveTo(q[0][0],q[0][1]);
    ctx.lineTo(q[1][0],q[1][1]);ctx.lineTo(q[2][0],q[2][1]);
    ctx.closePath();ctx.fill();ctx.stroke();
  }
  // emitter marker
  if(DATA.emitter){
    const p=view(DATA.emitter[0],DATA.emitter[1],DATA.emitter[2]);
    if(p[2]>0.05){
      ctx.fillStyle="#ff5544";
      ctx.beginPath();
      ctx.arc(W/2+f*p[0]/p[2],H/2-f*p[1]/p[2],Math.min(30,6/p[2]*8+3),0,7);
      ctx.fill();
    }
  }
  document.getElementById("hud").textContent=
    `pos ${pos.map(v=>v.toFixed(2)).join("  ")}\n`+
    `yaw ${(yaw*180/Math.PI-90).toFixed(1)}°  pitch ${(pitch*180/Math.PI).toFixed(1)}°\n`+
    `tris ${NT}  ${rec?(rec.active?"REC ● "+rec.times.length+" pts":"rec paused "+rec.times.length+" pts"):""}`;
}
let last=performance.now();
(function loop(){
  const now=performance.now();
  frame(Math.min((now-last)/1000,0.1)); last=now;
  requestAnimationFrame(loop);
})();
</script></body></html>
"""


def write_walkthrough_html(scene, path: str | Path, emitter=None,
                           receiver=None, receiver_yaw_deg: float = 0.0,
                           title: str = "AudioRenderingV2 walkthrough",
                           audio_wav_path: str | Path | None = None) -> Path:
    """Export an interactive first-person walkthrough of ``scene``.

    Args:
      scene: a :class:`scene.Scene` (padded triangles are dropped).
      emitter / receiver: optional [3] positions; the camera starts at the
        receiver, mirroring the reference's receiver-on-camera lock.
      audio_wav_path: optional rendered/auralized WAV to embed as a player.

    Returns the written path. The file is fully self-contained (no network,
    no external JS) — open it in any browser.
    """
    t = scene.n_triangles
    tris = np.stack([np.asarray(scene.v0)[:t], np.asarray(scene.v1)[:t],
                     np.asarray(scene.v2)[:t]], axis=1).astype(np.float32)
    data = {
        "tris": base64.b64encode(tris.tobytes()).decode("ascii"),
        "emitter": (np.asarray(emitter, np.float64).tolist()
                    if emitter is not None else None),
        "receiver": (np.asarray(receiver, np.float64).tolist()
                     if receiver is not None else None),
        "yaw_deg": float(receiver_yaw_deg),
    }
    audio_html = ""
    if audio_wav_path is not None:
        wav = Path(audio_wav_path).read_bytes()
        audio_html = ('<audio id="audio" controls src="data:audio/wav;'
                      f'base64,{base64.b64encode(wav).decode("ascii")}">'
                      "</audio>")
    html = (_TEMPLATE
            .replace("__TITLE__", title)
            .replace("__AUDIO__", audio_html)
            .replace("__DATA__", json.dumps(data)))
    out = Path(path)
    out.write_text(html, encoding="utf-8")
    return out
