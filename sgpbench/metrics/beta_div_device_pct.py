"""The beta objective kernel's share of the card's work in the profiled
stretch: 100 x its device time (every operation of the whole stretch whose
name holds ``beta_div_kernel``, as ``beta_div_roofline_pct`` reads them,
under the same naming contract) over the union of the device's activity
intervals (``busy_s``). None where the kernel did not run in the stretch or
both types' kernels did."""
import importlib.util
import os


def _roofline():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'beta_div_roofline_pct.py')
    spec = importlib.util.spec_from_file_location(
        'sgpbench_metric_beta_div_roofline_pct', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(rec):
    found = _roofline().kernel_time(rec)
    busy = (rec.get('profile') or {}).get('busy_s')
    if found is None or not busy:
        return None
    return 100.0 * found[0] / busy
