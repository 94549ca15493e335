from k8s_dra_driver_tpu_torch.plugins.webhook.main import main

raise SystemExit(main())
