"""UIServer: browser training dashboard over a StatsStorage (counterpart of
``deeplearning4j_tpu/ui/server.py``: the same pages, endpoints, keys and
status codes, over the port's singletons).

Reference: deeplearning4j-play/.../PlayUIServer.java:53 + api/UIServer.java
(``UIServer.getInstance().attach(statsStorage)``) and the UI modules
(module/train/TrainModule.java — overview/model/system pages;
histogram/HistogramModule.java — per-layer parameter/gradient/update
histograms; flow/FlowListenerModule.java — network graph view). The Play
framework is replaced by a stdlib ``http.server`` on a background thread
serving self-contained HTML pages (inline SVG charts, zero JS dependencies)
plus a JSON API; a remote-stats receiver endpoint accepts POSTs from
RemoteStatsStorageRouter (reference: ui/module/remote/).

Pages:
- ``/train/overview`` — score curve, throughput, sessions table.
- ``/train/model``    — per-layer parameter/gradient/update histograms and
  mean-magnitude time series (data from StatsListener).
- ``/train/system``   — host/device memory + iteration-time charts.
- ``/train/flow``     — the network graph rendered from the static report.
- ``/metrics``        — Prometheus text exposition of the telemetry registry
  (scrape target); ``/api/telemetry`` is its JSON twin plus a system
  snapshot (host RSS, device memory).
- ``/api/memory``     — device-memory accounting: the caching allocator's
  live per-card stats, the compile cache's per-entry pool records (the
  memory a captured CUDA graph holds) and the latest per-layer
  ``memory_report``.
- ``/api/flightrecorder`` — the anomaly flight recorder's event ring
  (``?last=N``) and the dump bundles written so far.
- ``/api/ircost``     — answers 501: the JAX package's IR lint and static
  roofline view reads XLA's lowered programs (``analysis/``,
  ``ops/kernel_select``), which the port does not have.
- ``/api/serving``    — serving snapshot: per-model traffic counters, exact
  p50/p99 request latency, batch fill, queue depth, decode sessions.
- ``/api/online``     — online-learning snapshot: per-trainer ingest rate,
  window/step counters, drift/rollback state, hot-swap history, and the
  checkpoint store's version listing (see docs/streaming.md).
- ``/api/fleet``      — multi-process fleet snapshot: every in-process
  FleetRouter's per-worker liveness/version/queue view plus merged exact
  p50/p99.
- ``/api/resilience`` — live state of every registered failure-handling
  site: retry policies (attempts/backoff), deadlines (expiries) and
  circuit breakers (state/cooldown) (see docs/robustness.md).
- ``/api/slo``        — declared SLOs, fast/slow-window burn rates per
  model and objective, and the recent breach history (see
  docs/observability.md § SLO burn-rate monitoring).
- ``/api/history``    — the process metric time-series store: downsampled
  series (select/range/step/agg grammar) + spliced timeline annotations;
  ``/train/history`` renders live sparklines over it (see
  docs/observability.md § Metric history & derived signals).
- ``POST /serving/predict`` / ``POST /serving/rnn`` — the batch-inference
  and continuous-decode endpoints over the process serving front-end
  (``serving.get_service()``; see docs/serving.md). The handler threads
  only submit to the service's micro-batchers: the batcher threads
  dispatch, and a dispatch that captures a bucket's CUDA graph takes
  ``runtime.compile_manager.capture_lock()`` exclusively, as every capture
  of the port does, while replays hold it shared.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from . import i18n
from .storage import StatsStorage, InMemoryStatsStorage

_STYLE = """
body{font-family:sans-serif;margin:20px;background:#f7f7f7}
h1{font-size:20px} .card{background:#fff;border:1px solid #ddd;border-radius:6px;
padding:12px;margin:12px 0} table{border-collapse:collapse}
td,th{border:1px solid #ccc;padding:4px 8px;font-size:13px}
nav a{margin-right:14px;font-size:14px} nav a.here{font-weight:bold}
select{font-size:13px;margin:0 8px 8px 0}
.hrow{display:flex;flex-wrap:wrap} .hcell{margin:6px 12px 6px 0}
.hcell h4{margin:2px 0;font-size:12px;font-weight:normal;color:#555}
"""

_NAV = """<nav>
<a href="/train/overview" id="nav-overview">@@train.nav.overview@@</a>
<a href="/train/model" id="nav-model">@@train.nav.model@@</a>
<a href="/train/system" id="nav-system">@@train.nav.system@@</a>
<a href="/train/flow" id="nav-flow">@@train.nav.flow@@</a>
<a href="/train/activations" id="nav-activations">@@train.nav.activations@@</a>
<a href="/train/tsne" id="nav-tsne">@@train.nav.tsne@@</a>
<a href="/train/history" id="nav-history">history</a>
<span style="float:right">@@train.nav.language@@:
<a href="/setlang/en">en</a> <a href="/setlang/ja">ja</a>
<a href="/setlang/ko">ko</a> <a href="/setlang/de">de</a>
<a href="/setlang/ru">ru</a> <a href="/setlang/zh">zh</a></span>
</nav>
<script>
const here = location.pathname.split('/').pop();
const el = document.getElementById('nav-'+here); if (el) el.className='here';
async function getJSON(u){ return (await fetch(u)).json(); }
// session ids / layer names arrive via the unauthenticated remote-stats POST
// receiver — escape before any innerHTML interpolation (stored-XSS guard)
function esc(s){ return String(s).replace(/[&<>"']/g,
  c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c])); }
async function firstSession(){
  const q = new URLSearchParams(location.search);
  if (q.get('session')) return q.get('session');
  const s = await getJSON('/api/sessions'); return s.length ? s[s.length-1] : null;
}
// per-worker filter (reference: TrainModule's worker selection): keeps a
// <select id="worker"> in sync with the session's workers; '' = all
async function workerParam(session){
  const sel = document.getElementById('worker');
  if (!sel) return '';
  const ws = await getJSON('/api/workers?session='+encodeURIComponent(session));
  const want = ['', ...ws];
  if (sel.options.length != want.length){
    const cur = sel.value;
    sel.innerHTML = want.map(w=>`<option value="${esc(w)}">${w?esc(w):'all workers'}</option>`).join('');
    if (want.includes(cur)) sel.value = cur;
  }
  return sel.value ? '&worker='+encodeURIComponent(sel.value) : '';
}
function lineChart(svg, xs, ys, color){
  if (!xs.length) return;
  const W = +svg.getAttribute('width')-20, H = +svg.getAttribute('height'), pad=30;
  const xmin=Math.min(...xs), xmax=Math.max(...xs);
  const ymin=Math.min(...ys), ymax=Math.max(...ys);
  const px=x=>pad+(W-pad)*(x-xmin)/Math.max(xmax-xmin,1e-9);
  const py=y=>H-pad-(H-2*pad)*(y-ymin)/Math.max(ymax-ymin,1e-9);
  const d='M'+xs.map((x,i)=>px(x)+','+py(ys[i])).join(' L');
  svg.innerHTML=`<path d="${d}" fill="none" stroke="${color||'#36c'}" stroke-width="1.5"/>`+
   `<text x="5" y="15" font-size="11">${ymax.toPrecision(5)}</text>`+
   `<text x="5" y="${H-pad+12}" font-size="11">${ymin.toPrecision(5)}</text>`;
}
function histChart(svg, bins, counts, color){
  if (!counts || !counts.length) return;
  const W=+svg.getAttribute('width'), H=+svg.getAttribute('height'), pad=14;
  const cmax=Math.max(...counts,1), bw=(W-2*pad)/counts.length;
  let s='';
  for (let i=0;i<counts.length;i++){
    const h=(H-2*pad)*counts[i]/cmax;
    s+=`<rect x="${pad+i*bw}" y="${H-pad-h}" width="${Math.max(bw-1,1)}" height="${h}" fill="${color||'#36c'}"/>`;
  }
  const lo=bins[0], hi=bins[bins.length-1];
  s+=`<text x="2" y="${H-2}" font-size="9">${lo.toPrecision(3)}</text>`;
  s+=`<text x="${W-46}" y="${H-2}" font-size="9">${hi.toPrecision(3)}</text>`;
  svg.innerHTML=s;
}
</script>"""


def _page(title: str, body: str) -> str:
    return (f"<!DOCTYPE html><html><head><title>deeplearning4j_tpu_torch — {title}"
            f"</title><style>{_STYLE}</style></head><body>"
            f"<h1>deeplearning4j_tpu_torch — {title}</h1>{_NAV}{body}</body></html>")


_OVERVIEW = _page("@@train.overview.title@@", """
<div class="card"><h3>@@train.overview.chart.score@@</h3><svg id="score" width="800" height="240"></svg></div>
<div class="card"><h3>@@train.overview.chart.itertime@@</h3><svg id="itertime" width="800" height="160"></svg></div>
<div class="card"><h3>@@train.overview.sessions@@</h3><table id="sessions"><tr><th>session</th><th>workers</th><th>updates</th><th>last score</th></tr></table></div>
<div class="card"><h3>@@train.overview.model@@</h3><pre id="model"></pre></div>
<script>
async function refresh(){
  const sessions = await getJSON('/api/sessions');
  const tbl = document.getElementById('sessions');
  tbl.innerHTML = '<tr><th>session</th><th>workers</th><th>updates</th><th>last score</th></tr>';
  for (const s of sessions){
    const ups = await getJSON('/api/updates?session='+encodeURIComponent(s));
    const last = ups.length ? ups[ups.length-1].score.toFixed(5) : '-';
    const workers = new Set(ups.map(u=>u.worker_id)).size;
    tbl.innerHTML += `<tr><td><a href="/train/model?session=${encodeURIComponent(s)}">${esc(s)}</a></td><td>${workers}</td><td>${ups.length}</td><td>${last}</td></tr>`;
    if (ups.length){
      lineChart(document.getElementById('score'), ups.map(u=>u.iteration), ups.map(u=>u.score));
      const ts = ups.filter(u=>u.iteration_time_ms!=null);
      lineChart(document.getElementById('itertime'), ts.map(u=>u.iteration), ts.map(u=>u.iteration_time_ms), '#c63');
    }
    const st = await getJSON('/api/static?session='+encodeURIComponent(s));
    if (st.length) document.getElementById('model').textContent = JSON.stringify(st[0], null, 2);
  }
}
refresh(); setInterval(refresh, 3000);
</script>""")

_MODEL = _page("@@train.model.title@@", """
<div class="card">
<label>Layer/parameter: <select id="layer"></select></label>
<label>Kind: <select id="kind">
  <option value="param">parameters</option>
  <option value="gradient">gradients</option>
  <option value="update">updates</option>
</select></label>
<label>Worker: <select id="worker"></select></label>
</div>
<div class="card"><h3>@@train.model.meanmag@@</h3><svg id="mm" width="800" height="220"></svg></div>
<div class="card"><h3>@@train.model.histogram@@</h3><svg id="hist" width="420" height="180"></svg></div>
<div class="card"><h3>@@train.model.allhist@@</h3><div class="hrow" id="allhist"></div></div>
<script>
let session=null;
async function refresh(){
  session = session || await firstSession(); if (!session) return;
  const wq = await workerParam(session);
  const kind = document.getElementById('kind').value;
  const sel = document.getElementById('layer');
  const mm = await getJSON('/api/meanmag?session='+encodeURIComponent(session)+wq);
  const series = mm[kind] || {};
  const keys = Object.keys(series);
  if (sel.options.length != keys.length){
    const cur = sel.value;
    sel.innerHTML = keys.map(k=>`<option>${esc(k)}</option>`).join('');
    if (keys.includes(cur)) sel.value = cur;
  }
  const name = sel.value || keys[0]; if (!name) return;
  lineChart(document.getElementById('mm'), mm.iterations, series[name]);
  const h = await getJSON('/api/histograms?session='+encodeURIComponent(session)+wq);
  const hk = h[kind+'_histograms'] || {};
  if (hk[name]) histChart(document.getElementById('hist'), hk[name].bins, hk[name].counts);
  const all = document.getElementById('allhist'); all.innerHTML='';
  for (const k of Object.keys(hk)){
    const id = 'h_'+k.replace(/[^a-zA-Z0-9]/g,'_');
    all.innerHTML += `<div class="hcell"><h4>${esc(k)}</h4><svg id="${id}" width="200" height="100"></svg></div>`;
  }
  for (const k of Object.keys(hk))
    histChart(document.getElementById('h_'+k.replace(/[^a-zA-Z0-9]/g,'_')), hk[k].bins, hk[k].counts, '#693');
}
document.getElementById('kind').addEventListener('change', refresh);
document.getElementById('worker').addEventListener('change', refresh);
document.getElementById('layer').addEventListener('change', refresh);
refresh(); setInterval(refresh, 5000);
</script>""")

_SYSTEM = _page("@@train.system.title@@", """
<div class="card"><h3>Host memory (RSS, MB)</h3><svg id="mem" width="800" height="180"></svg></div>
<div class="card"><h3>Device memory in use (MB)</h3><svg id="devmem" width="800" height="180"></svg></div>
<div class="card"><h3>Iteration time (ms)</h3><svg id="itertime" width="800" height="180"></svg></div>
<div class="card"><h3>Phase timings</h3><table id="phases"><tr><td>no phase data (attach a ParallelWrapper / bench StepTimer)</td></tr></table></div>
<div class="card"><h3>Environment</h3><table id="env"></table></div>
<script>
async function refresh(){
  const session = await firstSession(); if (!session) return;
  const sys = await getJSON('/api/system?session='+encodeURIComponent(session));
  const mem = sys.filter(u=>u.memory_rss_bytes!=null);
  lineChart(document.getElementById('mem'), mem.map(u=>u.iteration), mem.map(u=>u.memory_rss_bytes/1048576));
  const dev = sys.filter(u=>u.device_memory && u.device_memory.length);
  if (dev.length) lineChart(document.getElementById('devmem'), dev.map(u=>u.iteration),
    dev.map(u=>u.device_memory.reduce((a,d)=>a+(d.bytes_in_use||0),0)/1048576), '#936');
  const ts = sys.filter(u=>u.iteration_time_ms!=null);
  lineChart(document.getElementById('itertime'), ts.map(u=>u.iteration), ts.map(u=>u.iteration_time_ms), '#c63');
  const ph = sys.filter(u=>u.phase_timings);
  if (ph.length){
    const pt = ph[ph.length-1].phase_timings;
    let rows = '<tr><th>phase</th><th>total s</th><th>count</th><th>mean ms</th></tr>';
    for (const k of Object.keys(pt))
      rows += `<tr><td>${esc(k)}</td><td>${esc(pt[k].total_s)}</td><td>${esc(pt[k].count)}</td><td>${esc(pt[k].mean_ms)}</td></tr>`;
    document.getElementById('phases').innerHTML = rows;
  }
  const st = await getJSON('/api/static?session='+encodeURIComponent(session));
  if (st.length){
    const s = st[0];
    document.getElementById('env').innerHTML =
      `<tr><th>model</th><td>${esc(s.model_class)}</td></tr>`+
      `<tr><th>backend</th><td>${esc(s.backend||'-')}</td></tr>`+
      `<tr><th>params</th><td>${esc(s.num_params)}</td></tr>`+
      `<tr><th>pid</th><td>${esc(s.pid)}</td></tr>`;
  }
}
refresh(); setInterval(refresh, 3000);
</script>""")

_FLOW = _page("@@train.flow.title@@", """
<div class="card"><h3>Network graph</h3><svg id="flow" width="900" height="600"></svg></div>
<script>
async function refresh(){
  const session = await firstSession(); if (!session) return;
  const st = await getJSON('/api/static?session='+encodeURIComponent(session));
  if (!st.length || !st[0].graph) return;
  const g = st[0].graph, counts = st[0].param_counts || {};
  // layered layout: depth = longest path from any source
  const depth = {};
  for (const n of g.nodes) depth[n.name]=0;
  let changed=true, guard=0;
  while (changed && guard++<1000){
    changed=false;
    for (const e of g.edges){
      if (depth[e[1]] < depth[e[0]]+1){ depth[e[1]]=depth[e[0]]+1; changed=true; }
    }
  }
  const rows = {};
  for (const n of g.nodes) (rows[depth[n.name]] = rows[depth[n.name]]||[]).push(n);
  const pos = {}; const H=90, W=170;
  let maxRow = 0;
  for (const d of Object.keys(rows)) maxRow = Math.max(maxRow, rows[d].length);
  let svgH = (Object.keys(rows).length)*H+40;
  const svg = document.getElementById('flow');
  svg.setAttribute('height', Math.max(svgH, 300));
  let s='';
  for (const d of Object.keys(rows)){
    rows[d].forEach((n,i)=>{ pos[n.name]=[40+i*W+((maxRow-rows[d].length)*W/2), 30+d*H]; });
  }
  s+='<defs><marker id="arr" markerWidth="8" markerHeight="8" refX="7" refY="3" orient="auto"><path d="M0,0 L8,3 L0,6 z" fill="#888"/></marker></defs>';
  for (const e of g.edges){
    const a=pos[e[0]], b=pos[e[1]]; if(!a||!b) continue;
    s+=`<line x1="${a[0]+70}" y1="${a[1]+40}" x2="${b[0]+70}" y2="${b[1]}" stroke="#888" marker-end="url(#arr)"/>`;
  }
  for (const n of g.nodes){
    const p=pos[n.name]; if(!p) continue;
    const fill = n.type==='Input' ? '#dfe8f5' : (n.output ? '#f5e8df' : '#eef5df');
    const np = counts[n.name] ? Object.values(counts[n.name]).reduce((a,b)=>a+b,0) : null;
    s+=`<rect x="${p[0]}" y="${p[1]}" width="140" height="40" rx="6" fill="${fill}" stroke="#999"/>`;
    s+=`<text x="${p[0]+70}" y="${p[1]+16}" text-anchor="middle" font-size="11">${esc(n.name)}</text>`;
    s+=`<text x="${p[0]+70}" y="${p[1]+30}" text-anchor="middle" font-size="10" fill="#555">${esc(n.type)}${np?(' · '+np+'p'):''}</text>`;
  }
  svg.innerHTML=s;
}
refresh(); setInterval(refresh, 5000);
</script>""")

_ACTIVATIONS = _page("@@train.activations.title@@", """
<div class="card"><h3>First conv layer — feature maps (one input example)</h3>
<div id="meta" style="font-size:13px;color:#555"></div>
<div class="hrow" id="grids"></div></div>
<script>
async function refresh(){
  const session = await firstSession(); if (!session) return;
  const a = await getJSON('/api/activations?session='+encodeURIComponent(session));
  if (!a || !a.conv_activations) return;
  const ca = a.conv_activations;
  document.getElementById('meta').textContent =
    `layer ${ca.layer} · iteration ${a.iteration} · ${ca.maps.length} maps`;
  const grids = document.getElementById('grids'); grids.innerHTML='';
  ca.maps.forEach((m, idx) => {
    const h = m.length, w = m[0].length, px = 6;
    let s = '';
    for (let r = 0; r < h; r++)
      for (let c = 0; c < w; c++){
        const v = Math.round(255 * (1 - m[r][c]));
        s += `<rect x="${c*px}" y="${r*px}" width="${px}" height="${px}" fill="rgb(${v},${v},${v})"/>`;
      }
    grids.innerHTML += `<div class="hcell"><h4>map ${idx}</h4><svg width="${w*px}" height="${h*px}">${s}</svg></div>`;
  });
}
refresh(); setInterval(refresh, 4000);
</script>""")

_TSNE = _page("@@train.tsne.title@@", """
<div class="card"><h3>t-SNE embedding</h3><svg id="scatter" width="820" height="620"></svg></div>
<script>
const COLORS = ['#36c','#c63','#693','#936','#369','#c36','#663','#339','#933','#396'];
async function refresh(){
  const session = await firstSession(); if (!session) return;
  const t = await getJSON('/api/tsne?session='+encodeURIComponent(session));
  if (!t || !t.coords || !t.coords.length) return;
  const xs = t.coords.map(c=>c[0]), ys = t.coords.map(c=>c[1]);
  const xmin=Math.min(...xs), xmax=Math.max(...xs), ymin=Math.min(...ys), ymax=Math.max(...ys);
  const W=800, H=600, pad=20;
  const px=x=>pad+(W-2*pad)*(x-xmin)/Math.max(xmax-xmin,1e-9);
  const py=y=>pad+(H-2*pad)*(y-ymin)/Math.max(ymax-ymin,1e-9);
  const labels = t.labels || [];
  const classes = [...new Set(labels)];
  let s='';
  t.coords.forEach((c,i)=>{
    const color = labels.length ? COLORS[classes.indexOf(labels[i]) % COLORS.length] : '#36c';
    s += `<circle cx="${px(c[0])}" cy="${py(c[1])}" r="3" fill="${color}" opacity="0.7">`+
         `<title>${labels.length ? esc(labels[i]) : i}</title></circle>`;
  });
  classes.slice(0,10).forEach((cl,i)=>{
    s += `<circle cx="${W-90}" cy="${20+i*16}" r="4" fill="${COLORS[i % COLORS.length]}"/>`+
         `<text x="${W-80}" y="${24+i*16}" font-size="11">${esc(cl)}</text>`;
  });
  document.getElementById('scatter').innerHTML = s;
}
refresh(); setInterval(refresh, 5000);
</script>""")

_HISTORY = _page("metric history", """
<div class="card">
<h3>Metric history &amp; derived signals</h3>
<p style="font-size:13px;color:#555">Live sparklines over
<code>GET /api/history</code> — the bounded multi-resolution store fed
by the Deadline-paced sampler and the fleet scrape loop
(docs/observability.md § Metric history &amp; derived signals).
Vertical dashes mark spliced rollout/respawn/swap/slo-burn
annotations; dotted segments are explicit stale gaps.</p>
<label style="font-size:13px">series prefix
<input id="prefix" value="fleet." size="14"></label>
<label style="font-size:13px">window s
<input id="range" value="600" size="6"></label>
<span id="hstats" style="font-size:12px;color:#555"></span>
</div>
<div id="charts" class="hrow"></div>
<div class="card"><h3>annotations</h3>
<table id="anns"><tr><th>ts</th><th>kind</th><th>detail</th></tr></table>
</div>
<script>
function sparkline(svg, pts, anns, t0, t1, color){
  // pts: [ts, value|null] — nulls are stale gaps, drawn as path breaks
  const W=+svg.getAttribute('width'), H=+svg.getAttribute('height'), pad=6;
  const vals=pts.filter(p=>p[1]!==null).map(p=>p[1]);
  if (!vals.length) return;
  const ymin=Math.min(...vals), ymax=Math.max(...vals);
  const px=t=>pad+(W-2*pad)*(t-t0)/Math.max(t1-t0,1e-9);
  const py=v=>H-pad-(H-2*pad)*(v-ymin)/Math.max(ymax-ymin,1e-9);
  let d='', pen='M';
  for (const [t,v] of pts){
    if (v===null){ pen='M'; continue; }
    d+=pen+px(t).toFixed(1)+','+py(v).toFixed(1); pen=' L';
  }
  let s=`<path d="${d}" fill="none" stroke="${color||'#36c'}" stroke-width="1.2"/>`;
  for (const a of anns){
    const x=px(a.ts).toFixed(1);
    s+=`<line x1="${x}" y1="0" x2="${x}" y2="${H}" stroke="#c63" `+
       `stroke-dasharray="3,3"><title>${esc(a.kind)}</title></line>`;
  }
  s+=`<text x="2" y="10" font-size="9">${ymax.toPrecision(4)}</text>`;
  s+=`<text x="2" y="${H-1}" font-size="9">${ymin.toPrecision(4)}</text>`;
  svg.innerHTML=s;
}
async function refresh(){
  const prefix=document.getElementById('prefix').value||'';
  const range=+document.getElementById('range').value||600;
  const sel=prefix?('&series='+encodeURIComponent(prefix+'*')):'';
  const h=await getJSON('/api/history?range_s='+range+sel);
  const charts=document.getElementById('charts'); charts.innerHTML='';
  for (const s of h.series){
    if (!s.points.some(p=>p[1]!==null)) continue;
    const lab=Object.entries(s.labels).map(([k,v])=>k+'='+v).join(',');
    const cell=document.createElement('div'); cell.className='hcell';
    cell.innerHTML=`<h4>${esc(s.name)}${lab?' {'+esc(lab)+'}':''}`+
      `${s.stale?' <b style="color:#c63">stale</b>':''}</h4>`+
      `<svg width="260" height="64" style="background:#fff;`+
      `border:1px solid #ddd"></svg>`;
    charts.appendChild(cell);
    sparkline(cell.querySelector('svg'), s.points, h.annotations,
              h.start, h.end);
  }
  const tbl=document.getElementById('anns');
  tbl.innerHTML='<tr><th>ts</th><th>kind</th><th>detail</th></tr>'+
    h.annotations.slice(-30).reverse().map(a=>{
      const rest=Object.entries(a).filter(([k])=>k!=='ts'&&k!=='kind')
        .map(([k,v])=>k+'='+v).join(' ');
      return `<tr><td>${new Date(a.ts*1000).toISOString()}</td>`+
        `<td>${esc(a.kind)}</td><td>${esc(rest)}</td></tr>`;
    }).join('');
  document.getElementById('hstats').textContent =
    ` ${h.series.length} series · source=${h.source} · `+
    `${h.annotations.length} annotations`;
}
refresh(); setInterval(refresh, 3000);
</script>""")

_PAGES = {
    "/": _OVERVIEW,
    "/train": _OVERVIEW,
    "/train/overview": _OVERVIEW,
    "/train/model": _MODEL,
    "/train/system": _SYSTEM,
    "/train/flow": _FLOW,
    "/train/activations": _ACTIVATIONS,
    "/train/tsne": _TSNE,
    "/train/history": _HISTORY,
}

_HIST_KEYS = ("param_histograms", "gradient_histograms", "update_histograms")
_MM_KEYS = {"param": "param_mean_magnitudes",
            "gradient": "gradient_mean_magnitudes",
            "update": "update_mean_magnitudes"}
_SYSTEM_KEYS = ("iteration", "timestamp", "worker_id", "memory_rss_bytes",
                "iteration_time_ms", "device_memory", "phase_timings")


class _Handler(BaseHTTPRequestHandler):
    server_version = "DL4JTpuUI/0.2"

    def log_message(self, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _query(self) -> dict:
        from urllib.parse import urlparse, parse_qs

        q = parse_qs(urlparse(self.path).query)
        return {k: v[0] for k, v in q.items()}

    def _registry(self):
        """The metrics registry to expose: a server-attached one, else the
        process-wide default (telemetry.get_registry())."""
        reg = getattr(self.server, "registry", None)
        if reg is not None:
            return reg
        from ..telemetry import get_registry  # noqa: PLC0415

        return get_registry()

    def _updates(self, session: str, worker: Optional[str] = None) -> List[dict]:
        out: List[dict] = []
        for st in self.server.storages:  # type: ignore
            out.extend(st.get_all_updates(session, worker))
        return out

    def do_GET(self):
        storages: List[StatsStorage] = self.server.storages  # type: ignore
        path = self.path.split("?")[0].rstrip("/") or "/"
        if path in _PAGES:
            # ?lang=xx overrides per request; /setlang/xx sets the default
            # (reference: DefaultI18N + the Play setlang route)
            lang = self._query().get("lang") or None
            page = i18n.get_instance().render(_PAGES[path], lang)
            return self._send(200, page.encode(), "text/html")
        if path == "/metrics":
            # Prometheus scrape endpoint over the telemetry registry — the
            # alertable twin of the HTML dashboard
            text = self._registry().prometheus_text()
            return self._send(200, text.encode(),
                              "text/plain; version=0.0.4; charset=utf-8")
        if path == "/api/telemetry":
            from ..profiler import SystemInfoSampler  # noqa: PLC0415

            return self._send(200, json.dumps({
                "metrics": self._registry().snapshot(),
                "system": SystemInfoSampler.sample(),
            }).encode())
        if path == "/api/memory":
            # device-memory accounting: the allocator's live stats, the
            # compile cache's pool records, and the latest per-layer report
            from ..runtime.compile_manager import get_compile_manager  # noqa: PLC0415
            from ..telemetry import memory as _tmem  # noqa: PLC0415
            from ..telemetry.flight_recorder import get_flight_recorder  # noqa: PLC0415

            cm = get_compile_manager()
            return self._send(200, json.dumps({
                "devices": _tmem.device_memory_stats(self._registry()),
                "compile_cache": cm.stats(),
                "executables": cm.memory_records(),
                "report": get_flight_recorder().last_memory_report,
            }, default=str).encode())
        if path == "/api/ircost":
            return self._send(501, json.dumps({
                "error": "not implemented in the port: the IR cost view reads "
                         "XLA's lowered programs (analysis/, ops/kernel_select), "
                         "which the PyTorch port does not have"}).encode())
        if path == "/api/flightrecorder":
            from ..telemetry.flight_recorder import get_flight_recorder  # noqa: PLC0415

            try:
                last = int(self._query().get("last", "256"))
            except ValueError:
                last = 256
            return self._send(200, json.dumps(
                get_flight_recorder().snapshot(last), default=str).encode())
        if path == "/api/serving":
            # serving snapshot: per-model traffic, exact p50/p99 over the
            # recent-latency ring, batch fill, decode sessions, and the
            # shared compile cache that holds every model's executables
            from ..serving import get_service  # noqa: PLC0415

            return self._send(200, json.dumps(
                get_service().stats(), default=str).encode())
        if path == "/api/online":
            # online-learning snapshot: every OnlineTrainer's ingest/window
            # counters, drift state, rollbacks/swaps, and its checkpoint
            # store's version listing (docs/streaming.md)
            from ..runtime.online import get_online_trainers  # noqa: PLC0415

            return self._send(200, json.dumps(
                {"trainers": {name: t.stats()
                              for name, t in get_online_trainers().items()}},
                default=str).encode())
        if path == "/api/fleet":
            # fleet snapshot: every in-process FleetRouter's per-worker
            # liveness/version/queue view plus merged exact p50/p99
            from ..fleet import get_fleet_routers  # noqa: PLC0415

            return self._send(200, json.dumps(
                {"routers": [r.stats() for r in get_fleet_routers()]},
                default=str).encode())
        if path == "/api/resilience":
            # live state of every registered failure-handling site:
            # retry policies, deadlines, circuit breakers
            # (docs/robustness.md)
            from ..runtime.resilience import resilience_stats  # noqa: PLC0415

            return self._send(200, json.dumps(
                resilience_stats(), default=str).encode())
        if path == "/api/slo":
            # declared objectives + multi-window burn rates + recent
            # breaches (docs/observability.md § SLO burn-rate monitoring)
            from ..telemetry.slo import get_slo_monitor  # noqa: PLC0415

            return self._send(200, json.dumps(
                get_slo_monitor().stats(), default=str).encode())
        if path == "/api/history":
            # the process history store: downsampled series + spliced
            # annotations (docs/observability.md § Metric history &
            # derived signals; /train/history renders it)
            from ..telemetry.history import get_history_store  # noqa: PLC0415

            try:
                out = get_history_store().http_query(self._query())
            except ValueError as e:
                return self._send(400, json.dumps(
                    {"error": str(e)}).encode())
            return self._send(200, json.dumps(out).encode())
        if path.startswith("/setlang/"):
            prov = i18n.get_instance()
            code = path.rsplit("/", 1)[1]
            if code not in prov.languages():  # unknown code: reject loudly
                return self._send(404, b'{"error": "unknown language"}')
            prov.set_default_language(code)
            self.send_response(302)
            self.send_header("Location", "/train/overview")
            self.end_headers()
            return None
        q = self._query()
        sess = q.get("session", "")
        if path == "/api/sessions":
            out = sorted({s for st in storages for s in st.list_session_ids()})
            return self._send(200, json.dumps(out).encode())
        if path == "/api/workers":
            # workers with UPDATE records only (static-only pseudo-workers
            # like post_tsne's 'tsne' would render blank charts); backends
            # answer from their keys, no record materialization
            out = sorted({w for st in storages
                          for w in st.list_update_worker_ids(sess)})
            return self._send(200, json.dumps(out).encode())
        if path == "/api/updates":
            out = self._updates(sess, q.get("worker"))
            # slim payload for the overview chart; /api/histograms and
            # /api/meanmag serve the heavy sections (TrainModule split)
            drop = _HIST_KEYS + tuple(_MM_KEYS.values())
            slim = [{k: v for k, v in r.items() if k not in drop} for r in out]
            return self._send(200, json.dumps(slim).encode())
        if path == "/api/histograms":
            # latest update's histograms (or ?iteration=N for a specific one)
            out = self._updates(sess, q.get("worker"))
            want = q.get("iteration")
            rec = None
            if want is not None:
                rec = next((r for r in out if str(r.get("iteration")) == want), None)
            elif out:
                rec = out[-1]
            payload = {"iteration": rec.get("iteration") if rec else None}
            for key in _HIST_KEYS:
                payload[key] = (rec or {}).get(key, {})
            return self._send(200, json.dumps(payload).encode())
        if path == "/api/meanmag":
            out = self._updates(sess, q.get("worker"))
            payload = {"iterations": [r.get("iteration") for r in out]}
            n_rows = len(payload["iterations"])
            for kind, key in _MM_KEYS.items():
                series: dict = {}
                for i, r in enumerate(out):
                    for name, val in (r.get(key) or {}).items():
                        series.setdefault(name, [None] * n_rows)[i] = val
                payload[kind] = series
            return self._send(200, json.dumps(payload).encode())
        if path == "/api/system":
            out = self._updates(sess, q.get("worker"))
            slim = [{k: r[k] for k in _SYSTEM_KEYS if k in r} for r in out]
            return self._send(200, json.dumps(slim).encode())
        if path == "/api/activations":
            # latest update carrying conv feature maps
            out = self._updates(sess, q.get("worker"))
            rec = next((r for r in reversed(out) if "conv_activations" in r), None)
            return self._send(200, json.dumps(rec or {}).encode())
        if path == "/api/tsne":
            # latest posted t-SNE coordinate set (static records, see
            # conv_listener.post_tsne)
            stat = []
            for st in storages:
                stat.extend(st.get_static_info(sess))
            rec = next((r.get("tsne") for r in reversed(stat) if "tsne" in r), None)
            return self._send(200, json.dumps(rec or {}).encode())
        if path == "/api/static":
            out = []
            for st in storages:
                out.extend(st.get_static_info(sess))
            return self._send(200, json.dumps(out).encode())
        if path == "/api/i18n":
            prov = i18n.get_instance()
            return self._send(200, json.dumps({
                "default_language": prov.get_default_language(),
                "languages": list(prov.languages()),
                "messages": prov.catalog(q.get("lang") or None),
            }).encode())
        return self._send(404, b'{"error": "not found"}')

    def do_POST(self):
        """Remote stats receiver (reference: ui/module/remote/) + the
        batch-inference serving endpoints."""
        storages: List[StatsStorage] = self.server.storages  # type: ignore
        length = int(self.headers.get("Content-Length", 0))
        try:
            record = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            return self._send(400, b'{"error": "malformed JSON body"}')
        if self.path == "/serving/predict":
            return self._serve_predict(record)
        if self.path == "/serving/rnn":
            return self._serve_rnn(record)
        if not storages:
            return self._send(503, b'{"error": "no storage attached"}')
        if self.path == "/remote/static":
            storages[0].put_static_info(record)
        elif self.path == "/remote/update":
            storages[0].put_update(record)
        else:
            return self._send(404, b"{}")
        return self._send(200, b'{"status": "ok"}')

    def _serve_predict(self, record: dict):
        """POST /serving/predict {model, features, argmax?, timeout_s?}:
        one batch-inference request through the model's dynamic
        micro-batcher (requests from concurrent clients coalesce under the
        service latency budget into one padded pow2-bucket dispatch)."""
        from ..serving import get_service  # noqa: PLC0415

        name = record.get("model")
        feats = record.get("features")
        if not name or feats is None:
            return self._send(
                400, b'{"error": "need \'model\' and \'features\'"}')
        svc = get_service()
        try:
            out = svc.predict(
                name, feats, argmax=bool(record.get("argmax", False)),
                timeout_s=float(record.get("timeout_s", 30.0)))
        except KeyError as e:
            return self._send(404, json.dumps({"error": str(e)}).encode())
        except Exception as e:  # noqa: BLE001 - report, don't kill the server
            return self._send(500, json.dumps(
                {"error": f"{type(e).__name__}: {e}"[:500]}).encode())
        key = "classes" if record.get("argmax") else "output"
        import numpy as _np  # noqa: PLC0415

        return self._send(200, json.dumps(
            {"model": name, key: _np.asarray(out).tolist()}).encode())

    def _serve_rnn(self, record: dict):
        """POST /serving/rnn {model, op: open|step|close, session?,
        features?}: continuous-batching decode sessions. ``open`` claims a
        state slot, ``step`` submits one frame (concurrent sessions' steps
        coalesce into one masked rnn_time_step tick), ``close`` frees the
        slot."""
        from ..serving import get_service  # noqa: PLC0415

        name = record.get("model")
        op = record.get("op", "step")
        if not name:
            return self._send(400, b'{"error": "need \'model\'"}')
        svc = get_service()
        try:
            dec = svc.decoder(name)
            if op == "open":
                return self._send(200, json.dumps(
                    {"model": name, "session": dec.open()}).encode())
            sid = record.get("session")
            if not sid:
                return self._send(400, b'{"error": "need \'session\'"}')
            if op == "close":
                dec.close(sid)
                return self._send(200, json.dumps(
                    {"model": name, "closed": sid}).encode())
            if op != "step":
                return self._send(400, json.dumps(
                    {"error": f"unknown op {op!r}"}).encode())
            feats = record.get("features")
            if feats is None:
                return self._send(400, b'{"error": "need \'features\'"}')
            out = dec.step(sid, feats,
                           timeout_s=float(record.get("timeout_s", 30.0)))
            import numpy as _np  # noqa: PLC0415

            return self._send(200, json.dumps(
                {"model": name, "session": sid,
                 "output": _np.asarray(out).tolist()}).encode())
        except KeyError as e:
            return self._send(404, json.dumps({"error": str(e)}).encode())
        except Exception as e:  # noqa: BLE001 - report, don't kill the server
            return self._send(500, json.dumps(
                {"error": f"{type(e).__name__}: {e}"[:500]}).encode())


class UIServer:
    """Reference: api/UIServer.java — singleton, ``attach(statsStorage)``."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000, registry=None):
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._httpd.storages = []  # type: ignore
        # None -> the handler falls back to telemetry.get_registry()
        self._httpd.registry = registry  # type: ignore
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    @classmethod
    def get_instance(cls, port: int = 9000) -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer(port)
        return cls._instance

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def set_registry(self, registry) -> None:
        """Expose a specific MetricsRegistry at /metrics (None = process
        default)."""
        self._httpd.registry = registry  # type: ignore

    def attach(self, storage: StatsStorage) -> None:
        self._httpd.storages.append(storage)  # type: ignore

    def detach(self, storage: StatsStorage) -> None:
        self._httpd.storages.remove(storage)  # type: ignore

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if UIServer._instance is self:
            UIServer._instance = None


def main(argv=None, block_default: bool = False) -> "UIServer":
    """Standalone dashboard (reference: PlayUIServer's CLI with the port
    arg + remote-stats receiver): serve an existing stats storage, or an
    in-memory one fed by RemoteStatsStorageRouter POSTs from training
    processes. Run: ``python -m deeplearning4j_tpu_torch.ui.server --port 9000
    [--storage stats.db]`` — the module entry blocks by default (the HTTP
    thread is a daemon, so returning would kill the dashboard); tests call
    main() directly and get the server object back."""
    import argparse

    from .storage import FileStatsStorage, SqliteStatsStorage

    ap = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch.ui.server")
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument("--storage", default=None,
                    help=".db (sqlite) or .bin (file) stats storage to "
                         "serve; default: in-memory, fed by the remote "
                         "receiver (/remote)")
    ap.add_argument("--block", action=argparse.BooleanOptionalAction,
                    default=block_default,
                    help="keep the process alive (CLI default)")
    args = ap.parse_args(argv)
    server = UIServer.get_instance(port=args.port)
    if args.storage:
        storage = (SqliteStatsStorage(args.storage)
                   if args.storage.endswith(".db")
                   else FileStatsStorage(args.storage))
    else:
        storage = InMemoryStatsStorage()
    server.attach(storage)
    print(f"dl4j-tpu-torch UI at http://127.0.0.1:{server.port}/train/overview "
          f"(remote receiver at /remote)", flush=True)
    if args.block:  # pragma: no cover - interactive path
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            server.stop()
    return server


if __name__ == "__main__":
    main(block_default=True)
