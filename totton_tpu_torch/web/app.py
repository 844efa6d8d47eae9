"""aiohttp application: the reference web API/UI surface.

Route parity with the reference's FastAPI app (web/main.py + web/routers/*):

  GET  /, /settings                       Jinja2 pages
  GET  [/api]/eq/profiles                 list profiles
  GET  [/api]/eq/active                   active profile + parsed content
  POST [/api]/eq/validate                 validate an upload (multipart)
  POST [/api]/eq/import                   import an upload (multipart)
  POST [/api]/eq/import-text              import {name, content} JSON
  POST [/api]/eq/activate/{name}          activate profile + daemon reload
  POST [/api]/eq/deactivate               disable EQ
  DELETE [/api]/eq/profiles/{name}        delete profile
  GET  /opra/stats /opra/vendors /opra/search /opra/product/{id} /opra/eq/{id}
  POST /opra/apply/{eq_id}                write profile + activate
  GET  /api/opra/sync/status /api/opra/sync/available
  POST /api/opra/sync/update /api/opra/sync/rollback
  GET  /api/status
  GET/PUT /api/daemon/phase-type; POST /api/daemon/{reload,soft-reset,restart}
  GET  /api/alsa/devices
  GET/PATCH /api/config
"""

from __future__ import annotations

import asyncio
import json
from pathlib import Path

from aiohttp import web

import jinja2

from totton_tpu_torch.integration.opra import (
    apply_modern_target_correction,
    convert_opra_to_apo,
    get_database,
)
from totton_tpu_torch.integration.opra_sync import OpraSyncService, SyncInProgressError
from totton_tpu_torch.web import constants, i18n
from totton_tpu_torch.web.services import daemon as daemon_service
from totton_tpu_torch.web.services.config import (
    Settings,
    load_config,
    load_raw_config,
    save_config,
    save_config_updates,
)
from totton_tpu_torch.web.services.eq import (
    is_safe_profile_name,
    parse_eq_profile_content,
    validate_eq_profile_content,
    validate_upload,
)

_TEMPLATES = jinja2.Environment(
    loader=jinja2.FileSystemLoader(str(Path(__file__).parent / "templates")),
    autoescape=True,
)


def _json_error(status: int, detail: str) -> web.Response:
    return web.json_response({"detail": detail}, status=status)


def _reload_daemon_if_running() -> dict:
    """RELOAD when the daemon answers PING; flag restart_required when the
    daemon is up but reload fails (reference: web/routers/opra.py:31-46)."""
    client = daemon_service.get_client()
    if not client.ping():
        return {"daemon_running": False, "reloaded": False,
                "restart_required": False}
    ok = client.reload_config().ok
    return {"daemon_running": True, "reloaded": ok,
            "restart_required": not ok}


# --------------------------------------------------------------------- UI

def _render_page(request: web.Request, template: str, **context) -> web.Response:
    locale = i18n.negotiate_locale(request)
    html = _TEMPLATES.get_template(template).render(
        locale=locale,
        t=i18n.translator(locale),
        i18n_js=i18n.js_catalog(locale),
        **context,
    )
    return web.Response(text=html, content_type="text/html")


async def page_index(request: web.Request) -> web.Response:
    return _render_page(request, "index.html", settings=load_config())


async def page_settings(request: web.Request) -> web.Response:
    return _render_page(
        request, "settings.html", settings=load_config(),
        raw=json.dumps(load_raw_config(), indent=2),
    )


async def page_opra_sync(request: web.Request) -> web.Response:
    return _render_page(request, "opra_sync.html")


# --------------------------------------------------------------------- EQ

def _profiles_dir() -> Path:
    d = constants.eq_profiles_dir()
    d.mkdir(parents=True, exist_ok=True)
    return d


async def eq_profiles(request: web.Request) -> web.Response:
    profiles = []
    settings = load_config()
    for p in sorted(_profiles_dir().glob("*.txt")):
        profiles.append({
            "name": p.stem,
            "filename": p.name,
            "size_bytes": p.stat().st_size,
            "active": settings.eq_enabled and settings.eq_profile == p.stem,
        })
    return web.json_response({"profiles": profiles})


async def eq_active(request: web.Request) -> web.Response:
    settings = load_config()
    if not settings.eq_enabled or not settings.eq_profile_path:
        return web.json_response({"active": None})
    parsed = parse_eq_profile_content(Path(settings.eq_profile_path))
    return web.json_response({
        "active": settings.eq_profile,
        "path": settings.eq_profile_path,
        "content": parsed,
    })


async def eq_response_curve(request: web.Request) -> web.Response:
    """Frequency-response curve of a saved profile (or the active one) on a
    log grid — drives the dashboard's EQ plot. Beyond reference parity (the
    reference UI never visualizes the response it applies)."""
    import numpy as np

    from totton_tpu_torch.eq.apo import parse_eq_string
    from totton_tpu_torch.eq.biquad import profile_response

    name = request.query.get("name")
    if name is None:
        settings = load_config()
        if not settings.eq_enabled or not settings.eq_profile_path:
            return _json_error(404, "no active profile")
        path = Path(settings.eq_profile_path)
        name = settings.eq_profile
    else:
        if not is_safe_profile_name(name):
            return _json_error(400, "Invalid profile name")
        path = _profiles_dir() / f"{name}.txt"
    if not path.exists():
        return _json_error(404, f"Profile not found: {name}")

    try:
        points = min(2048, max(16, int(request.query.get("points", "256"))))
        sample_rate = float(request.query.get("sample_rate", "48000"))
        if not 8000.0 <= sample_rate <= 1536000.0:
            raise ValueError("sample_rate out of range")
    except ValueError as e:
        return _json_error(400, str(e))

    profile = parse_eq_string(path.read_text(encoding="utf-8"))
    freqs = np.geomspace(10.0, sample_rate / 2.0, points)
    resp = profile_response(profile, freqs, sample_rate)
    mag_db = 20.0 * np.log10(np.maximum(np.abs(resp), 1e-12))
    return web.json_response({
        "name": name,
        "sample_rate": sample_rate,
        "preamp_db": profile.preamp_db,
        "band_count": profile.active_band_count,
        "frequencies_hz": [round(float(f), 2) for f in freqs],
        "magnitude_db": [round(float(m), 3) for m in mag_db],
    })


async def _read_upload(request: web.Request) -> tuple[str, bytes]:
    reader = await request.multipart()
    async for part in reader:
        if part.name == "file":
            filename = part.filename or ""
            data = await part.read(decode=False)
            return filename, bytes(data)
    raise ValueError("multipart field 'file' is required")


async def eq_validate(request: web.Request) -> web.Response:
    try:
        filename, data = await _read_upload(request)
        content, safe, report = validate_upload(filename, data)
    except ValueError as e:
        return _json_error(400, str(e))
    report["filename"] = safe
    return web.json_response(report)


async def eq_import(request: web.Request) -> web.Response:
    try:
        filename, data = await _read_upload(request)
        content, safe, report = validate_upload(filename, data)
    except ValueError as e:
        return _json_error(400, str(e))
    if not report["valid"]:
        return web.json_response(
            {"detail": "Validation failed", **report}, status=400
        )
    (_profiles_dir() / safe).write_text(content)
    return web.json_response({"imported": safe[:-4], **report})


async def eq_import_text(request: web.Request) -> web.Response:
    try:
        payload = await request.json()
    except json.JSONDecodeError:
        return _json_error(400, "JSON body required")
    name = payload.get("name", "")
    content = payload.get("content", "")
    if not is_safe_profile_name(name) or not name:
        return _json_error(400, "Invalid profile name")
    report = validate_eq_profile_content(content)
    if not report["valid"]:
        return web.json_response(
            {"detail": "Validation failed", **report}, status=400
        )
    (_profiles_dir() / f"{name}.txt").write_text(content)
    return web.json_response({"imported": name, **report})


async def eq_activate(request: web.Request) -> web.Response:
    name = request.match_info["name"]
    if not is_safe_profile_name(name):
        return _json_error(400, "Invalid profile name")
    path = _profiles_dir() / f"{name}.txt"
    if not path.exists():
        return _json_error(404, f"Profile not found: {name}")
    settings = load_config()
    settings.eq_enabled = True
    settings.eq_profile = name
    settings.eq_profile_path = str(path)
    save_config(settings)
    return web.json_response({"activated": name, **_reload_daemon_if_running()})


async def eq_deactivate(request: web.Request) -> web.Response:
    settings = load_config()
    settings.eq_enabled = False
    settings.eq_profile = None
    settings.eq_profile_path = None
    save_config(settings)
    return web.json_response({"deactivated": True,
                              **_reload_daemon_if_running()})


async def eq_delete(request: web.Request) -> web.Response:
    name = request.match_info["name"]
    if not is_safe_profile_name(name):
        return _json_error(400, "Invalid profile name")
    path = _profiles_dir() / f"{name}.txt"
    if not path.exists():
        return _json_error(404, f"Profile not found: {name}")
    settings = load_config()
    if settings.eq_profile == name and settings.eq_enabled:
        return _json_error(409, "Cannot delete the active profile")
    path.unlink()
    return web.json_response({"deleted": name})


# ------------------------------------------------------------------- OPRA

async def opra_stats(request: web.Request) -> web.Response:
    try:
        db = get_database()
        return web.json_response({
            "vendors": db.vendor_count,
            "products": db.product_count,
            "eq_profiles": db.eq_profile_count,
        })
    except FileNotFoundError as e:
        return _json_error(503, str(e))


async def opra_vendors(request: web.Request) -> web.Response:
    try:
        return web.json_response({"vendors": get_database().get_vendors()})
    except FileNotFoundError as e:
        return _json_error(503, str(e))


async def opra_search(request: web.Request) -> web.Response:
    query = request.query.get("q", "")
    limit = int(request.query.get("limit", "50"))
    if not query:
        return _json_error(400, "query parameter 'q' is required")
    try:
        return web.json_response(
            {"results": get_database().search(query, limit=limit)}
        )
    except FileNotFoundError as e:
        return _json_error(503, str(e))


async def opra_product(request: web.Request) -> web.Response:
    try:
        product = get_database().get_product(request.match_info["product_id"])
    except FileNotFoundError as e:
        return _json_error(503, str(e))
    if product is None:
        return _json_error(404, "Product not found")
    return web.json_response(product)


async def opra_eq_preview(request: web.Request) -> web.Response:
    try:
        eq = get_database().get_eq_profile(request.match_info["eq_id"])
    except FileNotFoundError as e:
        return _json_error(503, str(e))
    if eq is None:
        return _json_error(404, "EQ profile not found")
    profile = convert_opra_to_apo(eq)
    modern = request.query.get("modern_target") in ("1", "true", "yes")
    if modern:
        profile = apply_modern_target_correction(profile)
    return web.json_response({
        "id": eq["id"],
        "author": profile.author,
        "details": profile.details,
        "modern_target": modern,
        "apo_text": profile.to_apo_format(),
    })


def _opra_attribution_header(eq: dict, profile) -> str:
    return "\n".join([
        f"# OPRA: {profile.name or eq.get('product_id', '')}",
        f"# Author: {profile.author}",
        "# License: CC BY-SA 4.0",
        "# Source: https://github.com/opra-project/OPRA",
        f"# Details: {profile.details}",
        "",
    ])


async def opra_apply(request: web.Request) -> web.Response:
    eq_id = request.match_info["eq_id"]
    try:
        eq = get_database().get_eq_profile(eq_id)
    except FileNotFoundError as e:
        return _json_error(503, str(e))
    if eq is None:
        return _json_error(404, "EQ profile not found")
    profile = convert_opra_to_apo(eq)
    modern = request.query.get("modern_target") in ("1", "true", "yes")
    if modern:
        profile = apply_modern_target_correction(profile)
    name = f"opra_{eq_id}" + ("_kb5000_7" if modern else "")
    content = _opra_attribution_header(eq, profile) + profile.to_apo_format() + "\n"
    path = _profiles_dir() / f"{name}.txt"
    path.write_text(content)

    settings = load_config()
    settings.eq_enabled = True
    settings.eq_profile = name
    settings.eq_profile_path = str(path)
    save_config(settings)
    return web.json_response({
        "applied": name,
        "modern_target": modern,
        **_reload_daemon_if_running(),
    })


# -------------------------------------------------------------- OPRA sync

def _sync_service(request: web.Request) -> OpraSyncService:
    return request.app["opra_sync"]


async def opra_sync_status(request: web.Request) -> web.Response:
    return web.json_response(_sync_service(request).status())


async def opra_sync_available(request: web.Request) -> web.Response:
    try:
        info = await asyncio.to_thread(_sync_service(request).check_available)
        return web.json_response(info)
    except Exception as e:
        return _json_error(502, f"upstream check failed: {e}")


async def opra_sync_update(request: web.Request) -> web.Response:
    commit = request.query.get("commit")
    svc = _sync_service(request)
    try:
        status = await asyncio.to_thread(svc.update, commit)
        return web.json_response(status)
    except SyncInProgressError as e:
        return _json_error(409, str(e))
    except Exception as e:
        return _json_error(502, f"sync failed: {e}")


async def opra_sync_rollback(request: web.Request) -> web.Response:
    svc = _sync_service(request)
    try:
        status = await asyncio.to_thread(svc.rollback)
        return web.json_response(status)
    except SyncInProgressError as e:
        return _json_error(409, str(e))
    except (RuntimeError, FileNotFoundError) as e:
        return _json_error(400, str(e))


# ----------------------------------------------------------- status/daemon

async def api_status(request: web.Request) -> web.Response:
    status = await asyncio.to_thread(daemon_service.get_full_status)
    status["config"] = load_raw_config()
    return web.json_response(status)


async def daemon_phase_get(request: web.Request) -> web.Response:
    r = daemon_service.get_client().get_phase_type()
    if not r.ok:
        return _json_error(503, r.message or "daemon unreachable")
    return web.json_response(r.data)


async def daemon_phase_put(request: web.Request) -> web.Response:
    try:
        payload = await request.json()
    except json.JSONDecodeError:
        return _json_error(400, "JSON body required")
    phase = payload.get("phase_type") or payload.get("phase")
    if phase not in (constants.PHASE_TYPE_MINIMUM, constants.PHASE_TYPE_LINEAR,
                     "min"):
        return _json_error(400, "phase_type must be minimum or linear")
    r = daemon_service.get_client().set_phase_type(phase)
    if not r.ok:
        return _json_error(503, r.message or r.error_code or "failed")
    return web.json_response(r.data)


async def daemon_reload(request: web.Request) -> web.Response:
    return web.json_response(_reload_daemon_if_running())


async def daemon_soft_reset(request: web.Request) -> web.Response:
    r = daemon_service.get_client().soft_reset()
    if not r.ok:
        return _json_error(503, r.message or "daemon unreachable")
    return web.json_response(r.data)


async def daemon_restart(request: web.Request) -> web.Response:
    """Process-level restart hook. The reference restarts the DSP Docker
    container over the Docker socket (web/services/docker_control.py); here
    the hook is injectable via app['restart_fn'] (deployment wires it to
    systemd/docker/k8s as appropriate)."""
    restart_fn = request.app.get("restart_fn")
    if restart_fn is None:
        return _json_error(501, "restart hook not configured")
    from totton_tpu_torch.web.services.restart import RestartError

    try:
        result = await asyncio.to_thread(restart_fn)
    except RestartError as e:
        return _json_error(502, str(e))
    return web.json_response({"restarted": bool(result)})


async def alsa_devices(request: web.Request) -> web.Response:
    r = daemon_service.get_client().list_devices()
    if r.ok:
        return web.json_response(r.data)
    # Daemon down: fall back to the local registry.
    from totton_tpu_torch.io.devices import list_devices

    return web.json_response(list_devices())


async def config_get(request: web.Request) -> web.Response:
    return web.json_response(load_raw_config())


async def config_patch(request: web.Request) -> web.Response:
    try:
        updates = await request.json()
    except json.JSONDecodeError:
        return _json_error(400, "JSON body required")
    if not isinstance(updates, dict):
        return _json_error(400, "JSON object required")
    if not save_config_updates(updates):
        return _json_error(500, "failed to write config")
    return web.json_response({
        "saved": True,
        "config": load_raw_config(),
        **_reload_daemon_if_running(),
    })


# ------------------------------------------------------------------ app

def create_app(
    opra_sync: OpraSyncService | None = None,
    restart_fn=None,
) -> web.Application:
    app = web.Application()
    app["opra_sync"] = opra_sync or OpraSyncService()
    if restart_fn is not None:
        app["restart_fn"] = restart_fn

    r = app.router
    r.add_get("/", page_index)
    r.add_get("/settings", page_settings)
    r.add_get("/opra-sync", page_opra_sync)

    for prefix in ("", "/api"):
        r.add_get(f"{prefix}/eq/profiles", eq_profiles)
        r.add_get(f"{prefix}/eq/active", eq_active)
        r.add_get(f"{prefix}/eq/response", eq_response_curve)
        r.add_post(f"{prefix}/eq/validate", eq_validate)
        r.add_post(f"{prefix}/eq/import", eq_import)
        r.add_post(f"{prefix}/eq/import-text", eq_import_text)
        r.add_post(f"{prefix}/eq/activate/{{name}}", eq_activate)
        r.add_post(f"{prefix}/eq/deactivate", eq_deactivate)
        r.add_delete(f"{prefix}/eq/profiles/{{name}}", eq_delete)

    r.add_get("/opra/stats", opra_stats)
    r.add_get("/opra/vendors", opra_vendors)
    r.add_get("/opra/search", opra_search)
    r.add_get("/opra/product/{product_id}", opra_product)
    # Reference path shape (web/routers/opra.py: GET /products/{product_id}).
    r.add_get("/opra/products/{product_id}", opra_product)
    r.add_get("/opra/eq/{eq_id}", opra_eq_preview)
    r.add_post("/opra/apply/{eq_id}", opra_apply)

    r.add_get("/api/opra/sync/status", opra_sync_status)
    r.add_get("/api/opra/sync/available", opra_sync_available)
    r.add_post("/api/opra/sync/update", opra_sync_update)
    r.add_post("/api/opra/sync/rollback", opra_sync_rollback)

    r.add_get("/api/status", api_status)
    r.add_get("/api/daemon/phase-type", daemon_phase_get)
    r.add_put("/api/daemon/phase-type", daemon_phase_put)
    r.add_post("/api/daemon/reload", daemon_reload)
    r.add_post("/api/daemon/soft-reset", daemon_soft_reset)
    r.add_post("/api/daemon/restart", daemon_restart)
    r.add_get("/api/alsa/devices", alsa_devices)
    r.add_get("/api/config", config_get)
    r.add_patch("/api/config", config_patch)

    static_dir = Path(__file__).parent / "static"
    if static_dir.is_dir():
        r.add_static("/static", str(static_dir))
    return app
