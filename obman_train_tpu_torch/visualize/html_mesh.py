"""Self-contained HTML mesh viewer (the JAX package's
``visualize/html_mesh.py``).

Headless replacement for the reference's pythreejs notebook rendering
(mano_train/visualize/visualizemeshes.py:8-140): exports hand/object meshes
to a single HTML file with an embedded three.js scene (orbit controls,
per-mesh colors).  Open in any browser; no notebook kernel needed.
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{margin:0;overflow:hidden;background:#111}}</style></head>
<body>
<script type="importmap">{{"imports":{{
 "three":"https://unpkg.com/three@0.160.0/build/three.module.js",
 "three/addons/":"https://unpkg.com/three@0.160.0/examples/jsm/"
}}}}</script>
<script type="module">
import * as THREE from 'three';
import {{OrbitControls}} from 'three/addons/controls/OrbitControls.js';
const meshes = {meshes_json};
const scene = new THREE.Scene();
const camera = new THREE.PerspectiveCamera(50, innerWidth/innerHeight, 0.1, 1e6);
const renderer = new THREE.WebGLRenderer({{antialias:true}});
renderer.setSize(innerWidth, innerHeight);
document.body.appendChild(renderer.domElement);
scene.add(new THREE.AmbientLight(0xffffff, 0.5));
const dir = new THREE.DirectionalLight(0xffffff, 1.5);
dir.position.set(1, 1, 1); scene.add(dir);
let bbox = new THREE.Box3();
for (const m of meshes) {{
  const g = new THREE.BufferGeometry();
  g.setAttribute('position', new THREE.Float32BufferAttribute(m.verts.flat(), 3));
  if (m.faces.length) g.setIndex(m.faces.flat());
  g.computeVertexNormals();
  const mat = new THREE.MeshStandardMaterial({{
    color: m.color, roughness: 0.6, transparent: true,
    opacity: m.opacity, side: THREE.DoubleSide}});
  const mesh = new THREE.Mesh(g, mat);
  scene.add(mesh);
  bbox.expandByObject(mesh);
}}
const center = bbox.getCenter(new THREE.Vector3());
const size = bbox.getSize(new THREE.Vector3()).length();
camera.position.set(center.x, center.y, center.z + size * 1.2);
const controls = new OrbitControls(camera, renderer.domElement);
controls.target.copy(center);
function animate() {{
  requestAnimationFrame(animate);
  controls.update();
  renderer.render(scene, camera);
}}
animate();
addEventListener('resize', () => {{
  camera.aspect = innerWidth/innerHeight; camera.updateProjectionMatrix();
  renderer.setSize(innerWidth, innerHeight);
}});
</script></body></html>
"""

DEFAULT_COLORS = ("#4488ff", "#ff6644", "#44cc66", "#cccc44")


def export_meshes_html(
    path: str,
    meshes: Sequence[dict],
    title: str = "obman_train_tpu_torch meshes",
) -> str:
    """Write an HTML viewer.

    Args:
      meshes: list of {"verts": (V, 3), "faces": (F, 3) or None,
        "color": "#rrggbb" (optional), "opacity": float (optional)}.
    """
    payload = []
    for i, m in enumerate(meshes):
        verts = np.asarray(m["verts"], np.float32)
        faces = m.get("faces")
        payload.append(
            {
                "verts": verts.round(4).tolist(),
                "faces": (
                    np.asarray(faces, np.int32).tolist()
                    if faces is not None
                    else []
                ),
                "color": m.get("color", DEFAULT_COLORS[i % len(DEFAULT_COLORS)]),
                "opacity": float(m.get("opacity", 0.85)),
            }
        )
    html = _TEMPLATE.format(title=title, meshes_json=json.dumps(payload))
    with open(path, "w") as f:
        f.write(html)
    return path


def export_sample_html(path: str, hand_verts, hand_faces, obj_verts=None,
                       obj_faces=None) -> str:
    """Convenience: one hand (+ optional object) scene."""
    meshes = [{"verts": hand_verts, "faces": hand_faces, "color": "#e0ac69"}]
    if obj_verts is not None:
        meshes.append(
            {"verts": obj_verts, "faces": obj_faces, "color": "#4488ff"}
        )
    return export_meshes_html(path, meshes)
