"""``open_gui()`` — browser front end for the scan workflow.

Reference: the Shiny app under ``inst/shiny_app/`` launched by
``OpenGUI()`` (SURVEY.md §3.1/§3.5/§4.5): tabs for reading geno/pheno/map,
running AM, and viewing summary + plots, wrapping the exported API 1:1.
A dependency-free stdlib ``http.server`` single-page app; unlike the
reference (where a long AM run blocks the reactive loop, SURVEY.md §4.5),
scans run on a worker thread and the page polls status. Each server keeps
its session (the data read, the runs and their results) and the device its
scans run on, CUDA unless started with ``device="cpu"``.
"""

from __future__ import annotations

import io
import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union

import torch

from eagleeverything_tpu_torch.utils.device import resolve_device

# Shared SVG Manhattan renderer (hover tooltips): used by the GUI page
# and embedded into plot_am(save='*.html') standalone exports (reference:
# PlotAM's optional plotly interactivity, SURVEY.md §3.1).
_MANHATTAN_JS = """
function eeEsc(s){return String(s).replace(/[&<>"']/g,
 c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]))}
function eeDrawManhattan(d,wrap,tip){
 const W=980,H=360,L=55,B=40,T=18,R=12,pw=W-L-R,ph=H-B-T;
 const xmax=d.x.reduce((a,b)=>a>b?a:b,1),ymax=d.t.reduce((a,b)=>a>b?a:b,1)*1.06;
 const sx=v=>L+v/xmax*pw, sy=v=>T+ph-v/ymax*ph;
 const cols=['#3b4cc0','#8ea0cc'];
 let s='<svg width='+W+' height='+H+' style="border:1px solid #ddd;border-radius:6px;background:#fff">';
 for(let g=0;g<=4;g++){const yv=ymax*g/4,y=sy(yv);
  s+='<line x1='+L+' y1='+y+' x2='+(W-R)+' y2='+y+' stroke="#eee"/>'+
     '<text x='+(L-6)+' y='+(y+4)+' font-size=10 text-anchor=end>'+yv.toFixed(1)+'</text>'}
 for(let i=0;i<d.x.length;i++){
  const sel=d.rank[i]>0, ch=d.change_it[i]>0;
  s+='<circle cx='+sx(d.x[i]).toFixed(1)+' cy='+sy(d.t[i]).toFixed(1)+
     ' r='+(sel?5:ch?3.4:2.4)+' fill="'+(sel?'#d7342f':ch?'#f09a38':cols[d.band[i]%2])+
     '" data-i='+i+'/>';
  if(sel)s+='<text x='+(sx(d.x[i])+5)+' y='+(sy(d.t[i])-5)+' font-size=10 fill="#d7342f">'+d.rank[i]+'</text>'}
 for(let k=0;k<d.ticks.length;k++)
  s+='<text x='+sx(d.ticks[k])+' y='+(H-B+16)+' font-size=10 text-anchor=middle>'+eeEsc(d.tick_labels[k])+'</text>';
 s+='<text x='+(L+pw/2)+' y='+(H-6)+' font-size=11 text-anchor=middle>'+(d.ticks.length?'chromosome':'SNP index')+'</text>'+
    '<text x=14 y='+(T+ph/2)+' font-size=11 text-anchor=middle transform="rotate(-90 14 '+(T+ph/2)+')">outlier statistic t</text></svg>';
 wrap.innerHTML=s;
 const svg=wrap.firstChild;
 svg.addEventListener('mousemove',e=>{
  const i=e.target.dataset?e.target.dataset.i:null;
  if(i==null){tip.style.display='none';return}
  tip.style.display='block';
  tip.style.left=(e.clientX+12)+'px';tip.style.top=(e.clientY+12)+'px';
  tip.innerHTML=eeEsc(d.name[i])+'<br>chr '+eeEsc(d.chr[i])+' : '+eeEsc(d.pos[i])+'<br>t = '+d.t[i].toFixed(2)+
   (d.change_it[i]>0?'<br>changed at iteration '+d.change_it[i]:'')+
   (d.rank[i]>0?'<br><b>selected #'+d.rank[i]+'</b>':'')});
 svg.addEventListener('mouseleave',()=>tip.style.display='none')}
"""

_TIP_CSS = ("position:fixed;display:none;background:#222;color:#fff;"
            "padding:.3rem .5rem;border-radius:4px;font-size:.8rem;"
            "pointer-events:none;z-index:9")


def render_manhattan_html(payload: dict, title: str = "eagle-tpu scan") -> str:
    """Self-contained interactive Manhattan page (data inlined, no server).

    ``payload`` is :func:`_plot_data`'s dict; the result is what
    ``plot_am(save='scan.html')`` writes."""
    import html as _html

    # marker/trait names come verbatim from user data files: escape the
    # title, and keep '<' out of the inline <script> block so a name
    # containing '</script>' can't terminate it
    title_esc = _html.escape(title)
    data_js = json.dumps(payload).replace("<", "\\u003c")
    return (
        "<!DOCTYPE html>\n<html><head><meta charset='utf-8'><title>"
        + title_esc
        + "</title></head>\n<body style='font-family:system-ui,sans-serif;"
          "margin:2rem'>\n<h2>" + title_esc + "</h2>\n"
        "<div id=wrap style='position:relative'></div>\n"
        "<div id=tip style='" + _TIP_CSS + "'></div>\n"
        "<script>" + _MANHATTAN_JS + "\n"
        "const DATA = " + data_js + ";\n"
        "eeDrawManhattan(DATA, document.getElementById('wrap'),"
        " document.getElementById('tip'));\n"
        "</script></body></html>\n"
    )


_PAGE = """<!DOCTYPE html>
<html><head><title>eagle-tpu</title><style>
body{font-family:system-ui,sans-serif;margin:2rem;max-width:70rem}
fieldset{margin-bottom:1rem;border:1px solid #ccc;border-radius:6px}
label{display:inline-block;min-width:9rem;margin:.2rem 0}
input[type=text]{width:24rem}button{margin:.3rem .2rem;padding:.4rem .9rem}
pre{background:#f6f6f6;padding: .7rem;border-radius:6px;overflow-x:auto}
img{max-width:100%;border:1px solid #ddd;border-radius:6px}
.err{color:#b00}
</style></head><body>
<h1>eagle-tpu — multiple-locus association mapping</h1>
<fieldset><legend>1. Data</legend>
<label>Genotype file</label><input type=text id=geno placeholder="examples/tutorial/geno.txt">
<select id=gtype><option>text</option><option>PLINK</option><option>vcf</option></select><br>
<label>Phenotype file</label><input type=text id=pheno placeholder="examples/tutorial/pheno.txt"><br>
<label>Map file</label><input type=text id=mapf placeholder="examples/tutorial/map.txt (optional)"><br>
<label>Zmat file</label><input type=text id=zmatf placeholder="incidence matrix (optional; repeated measures)"><br>
<button onclick="readData()">Read data</button>
<pre id=readout>no data loaded</pre></fieldset>
<fieldset><legend>2. Scan (AM)</legend>
<label>Trait</label><input type=text id=trait placeholder="y"><br>
<label>Fixed effects</label><input type=text id=fformula placeholder="age + sex (optional)"><br>
<label>maxit</label><input type=text id=maxit value="40">
<label>lambda</label><input type=text id=lam value="1.0"><br>
<button onclick="runAM()">Run AM</button>
<label>Traits (multi)</label><input type=text id=traits placeholder="y1,y2 (comma-separated)">
<button onclick="runMulti()">Run multi-trait AM</button>
<pre id=amout>not run</pre></fieldset>
<fieldset><legend>2b. Calibrate lambda (FPR4AM)</legend>
<label>Trait</label><input type=text id=ftrait placeholder="y">
<label>target FPR</label><input type=text id=fpr value="0.05" style="width:5rem">
<label>numreps</label><input type=text id=numreps value="50" style="width:5rem">
<button onclick="runFPR()">Calibrate</button>
<pre id=fprout>not run</pre></fieldset>
<fieldset><legend>3. Results</legend>
<button onclick="loadSummary()">Summary (Wald tests)</button>
<button onclick="drawManhattan()">Manhattan plot (interactive)</button>
<button onclick="document.getElementById('manh').src='/api/plot.png?'+Date.now()">Manhattan plot (PNG)</button>
<pre id=sumout></pre>
<div id=manhwrap style="position:relative"></div>
<div id=tip style="position:fixed;display:none;background:#222;color:#fff;
padding:.3rem .5rem;border-radius:4px;font-size:.8rem;pointer-events:none;z-index:9"></div>
<img id=manh></fieldset>
<script>
async function post(u,b){const r=await fetch(u,{method:'POST',headers:{'Content-Type':'application/json'},body:JSON.stringify(b)});return r.json()}
async function readData(){
 const r=await post('/api/read',{geno:geno.value,gtype:gtype.value,pheno:pheno.value,map:mapf.value,zmat:zmatf.value});
 readout.textContent=JSON.stringify(r,null,1); readout.className=r.error?'err':''}
async function runFPR(){
 fprout.textContent='calibrating...';
 await post('/api/fpr',{trait:ftrait.value||trait.value,fformula:fformula.value,falseposrate:fpr.value,numreps:numreps.value});
 pollFPR()}
async function pollFPR(){
 const r=await (await fetch('/api/fpr_status')).json();
 if(r.running){setTimeout(pollFPR,1500);return}
 fprout.className=r.error?'err':'';
 fprout.textContent=r.error?('ERROR: '+r.error):
  ('lambda* = '+r.result.lambda.toFixed(4)+'  (target FPR '+r.result.falseposrate+', '+r.result.numreps+' permutations)\n'
   +'use it in the Scan tab lambda field');}
async function runMulti(){
 amout.textContent='running multi-trait...';
 await post('/api/multi',{traits:traits.value,fformula:fformula.value,maxit:maxit.value,lam:lam.value});
 pollMulti()}
async function pollMulti(){
 const r=await (await fetch('/api/multi_status')).json();
 if(r.running){setTimeout(pollMulti,1500);return}
 amout.className=r.error?'err':'';
 amout.textContent=r.error?('ERROR: '+r.error):JSON.stringify(r.result,null,1)}
async function runAM(){
 amout.textContent='running...';
 await post('/api/am',{trait:trait.value,fformula:fformula.value,maxit:maxit.value,lam:lam.value});
 poll()}
async function poll(){
 const r=await (await fetch('/api/status')).json();
 amout.textContent=(r.log||[]).join('\\n')+(r.error?'\\nERROR: '+r.error:'');
 amout.className=r.error?'err':'';
 if(r.running){setTimeout(poll,1500)}else if(r.result){amout.textContent+='\\n'+JSON.stringify(r.result,null,1)}}
async function loadSummary(){
 const r=await (await fetch('/api/summary')).json();
 sumout.textContent=JSON.stringify(r,null,1); sumout.className=r.error?'err':''}
async function drawManhattan(){
 const d=await (await fetch('/api/plotdata')).json();
 if(d.error){manhwrap.textContent='ERROR: '+d.error;return}
 eeDrawManhattan(d,manhwrap,tip)}
</script></body></html>"""

# inject the shared renderer into the page's script block
_PAGE = _PAGE.replace("<script>", "<script>" + _MANHATTAN_JS, 1)


def _plot_data(res, map_h, max_points: int = 20000) -> dict:
    """Decimated per-SNP data for the interactive Manhattan (tooltips):
    peak t over iterations, chromosome striping bands, iteration-of-change
    (same rule as ``plot_am(highlight_changes=True)``), selected ranks.
    Payload is capped: all selected/changed/top-t SNPs plus a uniform
    background subsample."""
    import numpy as np

    from eagleeverything_tpu_torch.api.plot import change_iterations

    t = np.max(np.stack(res.outlier_stats), axis=0)
    p = t.shape[0]
    change_it = change_iterations(res.outlier_stats)

    if map_h is not None:
        chroms = np.asarray(map_h.chrom)
        uniq = list(dict.fromkeys(chroms.tolist()))
        x = np.empty(p)
        band = np.empty(p, dtype=int)
        ticks, tick_labels = [], []
        offset = 0.0
        for ci, c in enumerate(uniq):
            m = chroms == c
            pos = np.asarray(map_h.pos)[m].astype(float)
            span = (pos.max() - pos.min() + 1) if m.sum() else 1.0
            x[m] = offset + (pos - pos.min())
            band[m] = ci
            ticks.append(offset + span / 2)
            tick_labels.append(str(c))
            offset += span * 1.02
        names = map_h.marker_names
        chr_s = [str(c) for c in chroms]
        pos_s = [int(v) for v in np.asarray(map_h.pos)]
    else:
        x = np.arange(p, dtype=float)
        band = np.zeros(p, dtype=int)
        ticks, tick_labels = [], []
        names = res.marker_names or [f"snp{j}" for j in range(p)]
        chr_s = ["-"] * p
        pos_s = list(range(p))

    keep = np.zeros(p, dtype=bool)
    keep[list(res.indices)] = True
    if p <= max_points:
        keep[:] = True
    else:
        # priority fill under a hard cap: selected > changed (by t) >
        # top-t > uniform background — a scan where half the genome is
        # change-flagged must not ship half the genome
        budget = max_points - int(keep.sum())
        changed = np.flatnonzero(change_it > 0)
        if changed.size:
            take = changed[np.argsort(-t[changed], kind="stable")[:budget]]
            keep[take] = True
            budget = max_points - int(keep.sum())
        if budget > 0:
            k_top = min(budget, max_points // 2)
            keep[np.argpartition(t, -k_top)[-k_top:]] = True
            budget = max_points - int(keep.sum())
        if budget > 0:
            stride = max(1, -(-p // budget))  # ceil: never exceed budget
            keep[::stride] = True
    idx = np.flatnonzero(keep)
    rank = np.zeros(p, dtype=int)
    for r, j in enumerate(res.indices):
        rank[j] = r + 1
    return {
        "x": [round(float(v), 1) for v in x[idx]],
        "t": [round(float(v), 3) for v in t[idx]],
        "name": [str(names[j]) for j in idx],
        "chr": [chr_s[j] for j in idx],
        "pos": [pos_s[j] for j in idx],
        "band": band[idx].tolist(),
        "change_it": change_it[idx].tolist(),
        "rank": rank[idx].tolist(),
        "ticks": [round(float(v), 1) for v in ticks],
        "tick_labels": tick_labels,
    }


def _json_out(handler, obj, code=200):
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class _Session:
    """What one GUI server holds: the data read, the state of its three
    kinds of run (scan, fpr4am calibration, multi-trait scan — each on its
    own worker thread) and the device they run on. ``lock`` guards
    ``state``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self.state = {
            "geno": None, "pheno": None, "map": None, "zmat": None,
            "running": False, "log": [], "result": None, "error": None,
            # fpr4am calibration (reference FPR4AM tab)
            "fpr_running": False, "fpr_result": None, "fpr_error": None,
            # multi-trait scan (am_multi; BASELINE config 5)
            "multi_running": False, "multi_result": None,
            "multi_error": None,
        }


def _do_read(sess: _Session, params):
    import eagleeverything_tpu_torch as ee
    st = sess.state
    with sess.lock:
        st["geno"] = ee.read_marker(params["geno"],
                                    type=params.get("gtype", "text"))
        st["pheno"] = ee.read_pheno(params["pheno"])
        st["map"] = ee.read_map(params["map"]) if params.get("map") else None
        st["zmat"] = (ee.read_zmat(params["zmat"])
                      if params.get("zmat") else None)
        g, ph = st["geno"], st["pheno"]
    return {"genotypes": f"{g.n} individuals x {g.p} SNPs",
            "phenotype_columns": ph.names,
            "map": "loaded" if st["map"] else "none",
            "zmat": (f"{st['zmat'].shape[0]} records x "
                     f"{st['zmat'].shape[1]} individuals"
                     if st["zmat"] is not None else "none")}


def _run_am(sess: _Session, params):
    import eagleeverything_tpu_torch as ee
    st = sess.state
    try:
        res = ee.am(
            trait=params["trait"],
            geno=st["geno"], pheno=st["pheno"],
            fformula=params.get("fformula") or None,
            map=st["map"],
            Zmat=st["zmat"],
            maxit=int(params.get("maxit") or 40),
            lam=float(params.get("lam") or 1.0),
            quiet=True, device=sess.device,
        )
        with sess.lock:
            st["result"] = res
            st["log"].append(f"done: {len(res.indices)} markers selected")
    except Exception as e:
        with sess.lock:
            st["error"] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
    finally:
        with sess.lock:
            st["running"] = False


def _run_fpr(sess: _Session, params):
    import eagleeverything_tpu_torch as ee
    st = sess.state
    try:
        cal = ee.fpr4am(
            trait=params["trait"],
            geno=st["geno"], pheno=st["pheno"],
            fformula=params.get("fformula") or None,
            Zmat=st["zmat"],
            falseposrate=float(params.get("falseposrate") or 0.05),
            numreps=int(params.get("numreps") or 100),
            quiet=True, device=sess.device,
        )
        with sess.lock:
            st["fpr_result"] = {
                "lambda": cal["lambda"],
                "falseposrate": cal["falseposrate"],
                "numreps": cal["numreps"],
                "lambda_crits": [float(v) for v in cal["lambda_crits"]],
            }
    except Exception as e:
        with sess.lock:
            st["fpr_error"] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
    finally:
        with sess.lock:
            st["fpr_running"] = False


def _run_multi(sess: _Session, params):
    import eagleeverything_tpu_torch as ee
    st = sess.state
    try:
        traits = [t.strip() for t in str(params["traits"]).split(",")
                  if t.strip()]
        results = ee.am_multi(
            traits, st["geno"], st["pheno"],
            fformula=params.get("fformula") or None,
            map=st["map"],
            maxit=int(params.get("maxit") or 40),
            lam=float(params.get("lam") or 1.0),
            quiet=True, device=sess.device,
        )
        with sess.lock:
            st["multi_result"] = {
                name: {
                    "indices": r.indices,
                    "marker_names": r.marker_names,
                    "extbic_path": r.extbic_path,
                    "sigma2_g": r.sigma2_g, "sigma2_e": r.sigma2_e,
                } for name, r in results.items()}
    except Exception as e:
        with sess.lock:
            st["multi_error"] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
    finally:
        with sess.lock:
            st["multi_running"] = False


# POST route → (the prefix of its state's running/result/error slots, the
# busy message, its worker); a run clears its result and error as it starts
_RUNS = {
    "/api/am": ("", "a scan is already running", _run_am),
    "/api/fpr": ("fpr_", "a calibration is already running", _run_fpr),
    "/api/multi": ("multi_", "a multi-trait scan is already running",
                   _run_multi),
}


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet server logs
        pass

    @property
    def sess(self) -> _Session:
        return self.server.session

    def _result(self):
        res = self.sess.state["result"]
        if res is None:
            raise ValueError("run AM first")
        return res

    def do_GET(self):
        sess, st = self.sess, self.sess.state
        if self.path == "/" or self.path.startswith("/index"):
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/api/status"):
            with sess.lock:
                res = st["result"]
                out = {
                    "running": st["running"],
                    "log": list(st["log"]),
                    "error": st["error"],
                    "result": None if res is None else {
                        "indices": res.indices,
                        "marker_names": res.marker_names,
                        "chr": res.chr, "pos": res.pos,
                        "extbic_path": res.extbic_path,
                        "sigma2_g": res.sigma2_g, "sigma2_e": res.sigma2_e,
                    },
                }
            _json_out(self, out)
        elif self.path.startswith("/api/summary"):
            try:
                import eagleeverything_tpu_torch as ee
                res = self._result()
                s = ee.summary_am(res, trait=res.trait_name,
                                  geno=st["geno"], pheno=st["pheno"],
                                  quiet=True, device=sess.device)
                _json_out(self, {
                    "indices": s.indices, "beta": s.beta.tolist(),
                    "se": s.se.tolist(), "wald": s.wald.tolist(),
                    "pvalue": s.pvalue.tolist(),
                    "pct_var_explained": (100 * s.var_explained).tolist(),
                    "sigma2_g": s.sigma2_g, "sigma2_e": s.sigma2_e,
                })
            except Exception as e:
                _json_out(self, {"error": f"{type(e).__name__}: {e}"})
        elif self.path.startswith("/api/plotdata"):
            try:
                _json_out(self, _plot_data(self._result(), st["map"]))
            except Exception as e:
                _json_out(self, {"error": f"{type(e).__name__}: {e}"})
        elif self.path.startswith("/api/fpr_status"):
            with sess.lock:
                _json_out(self, {
                    "running": st["fpr_running"],
                    "error": st["fpr_error"],
                    "result": st["fpr_result"],
                })
        elif self.path.startswith("/api/multi_status"):
            with sess.lock:
                _json_out(self, {
                    "running": st["multi_running"],
                    "error": st["multi_error"],
                    "result": st["multi_result"],
                })
        elif self.path.startswith("/api/plot.png"):
            try:
                import eagleeverything_tpu_torch as ee
                fig = ee.plot_am(self._result(), map=st["map"])
                buf = io.BytesIO()
                fig.savefig(buf, format="png", dpi=120)
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Exception as e:
                _json_out(self, {"error": f"{type(e).__name__}: {e}"}, 500)
        else:
            _json_out(self, {"error": "not found"}, 404)

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        params = json.loads(self.rfile.read(length) or b"{}")
        sess, st = self.sess, self.sess.state
        if self.path.startswith("/api/read"):
            try:
                _json_out(self, _do_read(sess, params))
            except Exception as e:
                _json_out(self, {"error": f"{type(e).__name__}: {e}"})
            return
        route = next((r for r in _RUNS if self.path.startswith(r)), None)
        if route is None:
            _json_out(self, {"error": "not found"}, 404)
            return
        kind, busy, worker = _RUNS[route]
        with sess.lock:
            if st[kind + "running"]:
                _json_out(self, {"error": busy})
                return
            if st["geno"] is None:
                _json_out(self, {"error": "read data first"})
                return
            st.update({kind + "running": True, kind + "result": None,
                       kind + "error": None})
            if route == "/api/am":
                st["log"] = [f"scan started: trait={params.get('trait')}"]
        threading.Thread(target=worker, args=(sess, params),
                         daemon=True).start()
        _json_out(self, {"started": True})


def open_gui(host: str = "127.0.0.1", port: int = 8765,
             open_browser: bool = True, block: bool = True,
             device: Optional[Union[str, torch.device]] = None,
             ) -> Optional[ThreadingHTTPServer]:
    """Launch the GUI (reference: ``OpenGUI()``). Serves on
    http://host:port; its scans run on ``device`` (CUDA unless the caller
    passes ``"cpu"``). ``block=False`` returns the server (for tests)."""
    dev = resolve_device(device)
    server = ThreadingHTTPServer((host, port), _Handler)
    server.session = _Session(dev)
    print(f"eagle-tpu GUI: http://{host}:{server.server_address[1]}/ "
          f"(scans on {dev})")
    if open_browser:
        try:
            import webbrowser
            webbrowser.open(f"http://{host}:{server.server_address[1]}/")
        except Exception:
            pass
    if block:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return None
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
