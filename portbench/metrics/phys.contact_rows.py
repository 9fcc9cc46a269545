"""Active contact rows of a physics substep (the frame's last): the
program's `phys.contact_rows` counter, the mean over the traced run's
frames that time their spans."""

from portbench.readers import span_mean

META = {"unit": "rows", "better": "lower", "source": "program_counter",
        "layer": "physics", "moves": "frame_ms"}
read = span_mean("phys.contact_rows")
