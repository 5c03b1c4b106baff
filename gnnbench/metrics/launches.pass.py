"""Kernels launched per whole-graph pass, counted in the device trace."""


def read(reading):
    prof = reading.get("profile")
    if prof is None or not prof.dev_names or not reading["units"]:
        return None
    return prof.n_kernels / reading["units"]
