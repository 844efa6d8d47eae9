/* Shared web UI helpers. Pages attach their own logic in inline scripts. */

async function getJSON(url, opts) {
  const r = await fetch(url, opts);
  const body = await r.json().catch(() => ({}));
  if (!r.ok) throw new Error(body.detail || r.statusText);
  return body;
}

function postJSON(url, payload) {
  return getJSON(url, {
    method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(payload),
  });
}

function el(tag, attrs, ...children) {
  const node = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs || {})) {
    if (k === 'onclick') node.onclick = v;
    else if (k === 'class') node.className = v;
    else node.setAttribute(k, v);
  }
  node.append(...children);
  return node;
}

function tr(key) {
  return (window.I18N && window.I18N[key]) || key;
}

function flash(id, message, ok) {
  const box = document.getElementById(id);
  if (!box) return;
  box.textContent = message;
  box.className = 'flash ' + (ok ? 'flash-ok' : 'flash-err');
}

/* Buttons with data-confirm get a confirmation dialog before their real
 * handler runs (used by the DSP restart button). */
document.addEventListener('DOMContentLoaded', () => {
  for (const btn of document.querySelectorAll('button[data-confirm]')) {
    btn.addEventListener('click', (ev) => {
      if (!window.confirm(btn.dataset.confirm)) {
        ev.stopImmediatePropagation();
        ev.preventDefault();
      }
    }, true);
  }
});
