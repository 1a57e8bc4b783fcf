"""The reference's side of each diagram series: ``reference/series/<series>.py``
builds the series' roots with the frozen front end (``fdgraph``) and
returns ``(roots, n_loop, n_tau, green_id, interaction_id)``, the last two
the front end's id classes of a bare propagator and interaction."""
