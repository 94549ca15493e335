from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.main import main

raise SystemExit(main())
