from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.main import main

raise SystemExit(main())
