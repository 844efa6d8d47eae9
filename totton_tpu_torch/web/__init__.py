"""The web layer's constants and config service, copied from the JAX
package (``web/constants.py``, ``web/services/config.py``) for the
control plane's wiring; the web app itself is not ported."""
