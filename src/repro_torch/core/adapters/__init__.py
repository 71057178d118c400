"""Legacy single-resource adapters (deprecation shims): ``KVTier``,
``ExpertCache`` and ``EmbedCache``, each a thin view over one resource
registered on a multiplexed :class:`repro_torch.tiering.NeoMemDaemon`
(README, "Migrating off the legacy adapters")."""
